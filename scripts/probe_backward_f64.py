"""The training backward (B5/B7) against its plain version and float64, on
one NVIDIA GPU. Two parts:

  seed    one seed of ``torch_flagship_error_bar.py`` (its flagship
          arguments: 80 epochs, 30 held-out scenes, the same bucket and
          batches), trained through ``fit_device`` as the error bar trains
          it, up to the last epoch of ``--at``. At the end of each epoch of
          ``--at``, at that epoch's weights and over every training batch
          (in order): the training forward's scores (B4/B6) against the
          plain version (``chip_smoke.held_to_plain``: float64 decides past
          RTOL, ATOL), and the backward's gradients under the batch's own
          loss cotangent (taken at the plain version's scores) against
          autograd of the plain version (``chip_smoke.compare_grads``:
          float64 decides past the gradient tolerance, the plain version
          under the backward's own ReLU masks past that), with every
          gradient tensor's RMS distance from float64 beside the float32
          plain version's. The check runs on a copy of the model: the
          training run goes on as it would without it. Then epoch
          ``--steps-of``'s steps one by one, eagerly, on a second trainer
          loaded with the state at the end of the epoch before, each step's
          batch checked at the weights the step starts from; and the same
          steps through the plain version in float32 and in float64.
  spread  at ``chip_smoke.F64_CASES``'s shapes (random inputs of a numpy seed,
          ``init_params_``'s mm draw, a uniform cotangent on the logits, as
          the smoke's phase 2b): every gradient tensor's RMS distance from
          float64, for the kernel and for the float32 plain version, with
          each window's valid edges in ORDERS orders (the first as
          given). An order changes no value, only the order of float32's
          sums, so the readings over the orders are float32's own spread.
          The classifier's last bias takes the sum of the cotangent over the
          valid edges: its distance is also given in units of 2^-24 times
          the sum of their magnitudes. ``--other CHECKOUT`` runs the same
          part on another checkout's package in a process of its own (its
          kernels built there), after this one's.

    python scripts/probe_backward_f64.py seed [--seed 1] [--at 45,46,47,48,49] [--steps-of 49]
    python scripts/probe_backward_f64.py spread [--other CHECKOUT]

Prints its readings and, last, one JSON line with the card's name and power
limit. Exits non-zero if a check of the seed part fails."""

import argparse
import copy
import functools
import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
# the spread part's shapes: chip_smoke.py's F64_CASES (mm, (N, E), windows);
# its inputs' numpy seed and its number of edge orders
SPREAD_CASES = (((1024, 32768), 1), ((64, 512), 8))
INPUT_SEED, ORDERS = 17, 4


def card_name() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()


def rms_readings(g, ref64):
    """Per gradient tensor: RMS of ``g``'s distance from its float64 run."""
    return {k: float(((g[k].double() - r) ** 2).mean().sqrt()) for k, r in ref64.items()}


def batch_check(cs, model, graph, enc, batch_size, what):
    """One training batch at ``model``'s weights: the forward's scores and
    the backward's gradients held to the plain version, float64 deciding;
    returns the readings."""
    import torch

    from batch3dmot_tpu_torch.ops.fused_mp import extract_mp_params, fused_mp_scores_plain
    from batch3dmot_tpu_torch.ops.fused_mp_train import (
        fused_mp_train_masks,
        fused_mp_train_scores,
    )
    from batch3dmot_tpu_torch.train.metrics import masked_bce_terms

    depth = model.depth
    with torch.no_grad():
        x0, e0, att, _ = model.pre_message_passing(graph, *enc)
    inputs = (x0, e0, att, graph.edge_src, graph.edge_dst, graph.edge_mask)
    flat, meta = extract_mp_params(model, True, model.node_dim, model.edge_dim)
    with torch.no_grad():
        plain = fused_mp_scores_plain(*inputs, flat, meta, depth)
        logits = fused_mp_scores_plain(*inputs, flat, meta, depth, True)
    s = plain.detach().clone().requires_grad_()
    total, count = masked_bce_terms(s.reshape(-1), graph.edge_label.reshape(-1),
                                    graph.edge_mask.reshape(-1),
                                    graph.edge_weight.reshape(-1))
    (ct,) = torch.autograd.grad(total / torch.clamp(count, min=1.0) / batch_size, s)
    scores, _, _, kmasks = fused_mp_train_masks(*inputs, flat, meta, depth, ct, False)
    f_err, f_reading = cs.held_to_plain(
        scores, plain,
        lambda: cs.fused_mp_plain64(*inputs, flat, meta, depth), f"{what} scores")
    _, g_k = cs.train_grads(model, inputs, ct, depth, False, fused_mp_train_scores)
    _, g_p = cs.train_grads(model, inputs, ct, depth, False, fused_mp_scores_plain)
    m64 = copy.deepcopy(model).double()
    i64 = [t.double() if t is not None and t.is_floating_point() else t for t in inputs]
    _, g64 = cs.train_grads(m64, i64, ct.double(), depth, False, fused_mp_scores_plain)
    del m64
    rk, rp = rms_readings(g_k, g64), rms_readings(g_p, g64)
    g_err, tied = cs.compare_grads(
        g_k, g_p, lambda: g64, what,
        lambda: cs.train_grads(model, inputs, ct, depth, False, functools.partial(
            fused_mp_scores_plain, relu_masks=kmasks))[1])
    model.zero_grad(set_to_none=True)
    ratios = {k: rk[k] / rp[k] if rp[k] > 0 else (0.0 if rk[k] == 0 else float("inf"))
              for k in rk}
    return dict(valid_edges=int(graph.edge_mask.sum()),
                saturated=int(((ct == 0) & graph.edge_mask).sum()),
                max_abs_logit_plain=float(logits[graph.edge_mask].abs().max()),
                scores_err=f_err, scores_f64=f_reading, grads_err=g_err,
                tied=[t[0] for t in tied], rms_kernel=rk, rms_plain=rp, ratios=ratios)


def summarize(rows, label, loss):
    """One line and one dict of a list of ``batch_check`` readings."""
    worst = {}
    for r in rows:
        for k, q in r["ratios"].items():
            worst[k] = max(worst.get(k, 0.0), q)
    top = sorted(worst.items(), key=lambda kv: -kv[1])[:4]
    median = float(np.median([q for r in rows for q in r["ratios"].values()]))
    row = dict(loss=loss, batches=len(rows),
               scores_err=max(r["scores_err"] for r in rows),
               scores_f64=[r["scores_f64"] for r in rows if r["scores_f64"]],
               grads_err=max(r["grads_err"] for r in rows),
               tied=sorted({k for r in rows for k in r["tied"]}),
               max_abs_logit=max(r["max_abs_logit_plain"] for r in rows),
               saturated=sum(r["saturated"] for r in rows),
               valid_edges=sum(r["valid_edges"] for r in rows),
               median_ratio=median, worst_ratios=top)
    print(f"{label}: loss {loss:.6g}; {len(rows)} batches, {row['valid_edges']} valid edges "
          f"({row['saturated']} with a zero cotangent), max |logit| "
          f"{row['max_abs_logit']:.4g}; scores max|kernel-plain| {row['scores_err']:.3e} "
          f"({len(row['scores_f64'])} batches decided by float64); gradients "
          f"max|kernel-plain| {row['grads_err']:.3e}, tensors held to the relative L2 bound "
          f"or float64 {row['tied']}; RMS from float64 kernel / f32 plain: median "
          f"{median:.3f}, largest " + ", ".join(f"{k} {q:.2f}" for k, q in top), flush=True)
    return row


def checked(cs, model, graph, enc, batch_size, what, failures):
    """``batch_check``, its failure recorded instead of raised."""
    try:
        return batch_check(cs, model, graph, enc, batch_size, what)
    except AssertionError as exc:
        failures.append(f"{what}: {exc!r}"[:2000])
        print(f"FAILED {failures[-1]}", flush=True)
        return None


def side_steps(cs, trainer, ds, seed, epoch, failures, through="kernel"):
    """Epoch ``epoch``'s steps, one by one and eagerly, on a second trainer
    loaded with ``trainer``'s state at the end of the epoch before (weights,
    Adam's moments). Through the kernels each step's batch is checked at
    the weights it starts from (``batch_check``), then the step is taken;
    ``through="plain"`` or ``"plain64"`` takes the steps through the plain
    version (``chip_smoke.plain_training``) and reads each batch's largest
    |logit| before its step. The batches are those ``fit_device(ds,
    seed=seed)`` draws for that epoch. Returns the readings per step."""
    import contextlib
    import tempfile

    import torch

    from batch3dmot_tpu_torch.models import MultimodalGNN
    from batch3dmot_tpu_torch.ops.fused_mp import extract_mp_params, fused_mp_scores_plain
    from batch3dmot_tpu_torch.train.trainer import GNNTrainer, index_rows

    with tempfile.TemporaryDirectory() as tmp:
        path = trainer.save_state(os.path.join(tmp, "state.pt"))
        side = GNNTrainer(MultimodalGNN(depth=trainer.model.depth), trainer.cfg,
                          device=trainer.device)
        side.load_state(path)
    res = side._upload_dataset_groups([ds])[0]
    rng = np.random.default_rng(seed)
    for _ in range(epoch + 1):  # fit_device draws one order per epoch of one group
        order = rng.permutation(res.n_items)
    idx = side._upload_rows(index_rows(order, res.n_items, trainer.cfg.batch_size))
    steps = []
    for k in range(idx.shape[0]):
        graph, enc = side._gather_device_batch(res.graphs, res.enc, idx[k])
        label = f"seed {seed} epoch {epoch} step {k}"
        if through == "kernel":
            r = checked(cs, side.model, graph, enc, trainer.cfg.batch_size, label, failures)
        else:
            m = side.model
            with torch.no_grad():
                x0, e0, att, _ = m.pre_message_passing(graph, *enc)
                flat, meta = extract_mp_params(m, True, m.node_dim, m.edge_dim)
                logits = fused_mp_scores_plain(x0, e0, att, graph.edge_src, graph.edge_dst,
                                               graph.edge_mask, flat, meta, m.depth, True)
            r = float(logits[graph.edge_mask].abs().max())
        with (contextlib.nullcontext() if through == "kernel"
              else cs.plain_training(float64=through == "plain64")):
            loss = float(side._device_step(res, idx[k], True)[0])
        torch.cuda.synchronize()
        if through != "kernel":
            steps.append(dict(step=k, loss=loss, max_abs_logit=r))
            print(f"{label} (eager, through the {through} version): loss {loss:.6g}, "
                  f"max |logit| before it {r:.4g}", flush=True)
        elif r is not None:
            steps.append(dict(step=k, **summarize([r], f"{label} (eager, checked before it)",
                                                  loss)))
    return steps


def seed_part(args) -> dict:
    import torch

    sys.path.insert(0, os.path.join(HERE, ".."))
    import chip_smoke as cs
    import torch_flagship_error_bar as eb
    import torch_flagship_synthetic as fs
    from batch3dmot_tpu_torch.train.encoded import (
        EncodedGraphBatcher,
        materialize_encoded_dataset_dedup,
    )

    at = sorted(int(a) for a in args.at.split(","))
    fargs = fs.build_parser().parse_args(
        eb.seed_argv(args.seed, eb.BAND_SHAPE[0], eb.BAND_SHAPE[1], "") + ["--device", "cuda"])
    _, _, trainer, train_items, _, buckets = fs.prepare(fargs)
    ds = materialize_encoded_dataset_dedup(train_items, buckets=buckets)
    batches = list(EncodedGraphBatcher(train_items, batch_size=fargs.batch_size,
                                       buckets=buckets, uniform=True).epoch(shuffle=False))
    epochs, steps, failures = [], {}, []
    finish = trainer._finish_epoch

    def finish_and_check(epoch, m, *a, **kw):
        finish(epoch, m, *a, **kw)
        if epoch + 1 == args.steps_of:
            for through in ("kernel", "plain", "plain64"):
                steps[through] = side_steps(cs, trainer, ds, fargs.train_seed,
                                            args.steps_of, failures, through)
        if epoch not in at:
            return
        model = copy.deepcopy(trainer.model)
        rows = []
        for bi, batch in enumerate(batches):
            graph, enc = trainer._to_device(batch)
            r = checked(cs, model, graph, enc, fargs.batch_size,
                        f"seed {args.seed} epoch {epoch} batch {bi}", failures)
            if r is not None:
                rows.append(r)
        torch.cuda.synchronize()
        if rows:
            epochs.append(dict(epoch=epoch, **summarize(
                rows, f"seed {args.seed} epoch {epoch}", m.get("train/loss"))))

    trainer._finish_epoch = finish_and_check
    history = trainer.fit_device(ds, epochs=max(at[-1], args.steps_of) + 1, verbose=True,
                                 seed=fargs.train_seed)
    return dict(seed=args.seed, at=at, epochs=epochs, steps_of=args.steps_of, steps=steps,
                losses=[h["train/loss"] for h in history], failures=failures)


def permuted(rng, inputs, orders):
    """Index rows [B, E] of ``orders`` orders of each window's valid edges
    (the first as given; the padding stays in place)."""
    import torch

    mask = inputs[-1].cpu().numpy()
    b, e = mask.shape
    out = []
    for o in range(orders):
        rows = np.tile(np.arange(e), (b, 1))
        if o:
            for w in range(b):
                nv = int(mask[w].sum())
                rows[w, :nv] = rng.permutation(nv)
        out.append(torch.from_numpy(rows).to(inputs[-1].device))
    return out


def reorder(t, rows):
    """``t`` [B, E, ...] with each window's edges taken in the order ``rows``."""
    import torch

    if t is None:
        return None
    idx = rows.reshape(*rows.shape, *([1] * (t.dim() - 2))).expand(*rows.shape, *t.shape[2:])
    return torch.gather(t, 1, idx)


def spread_part(args) -> dict:
    import torch

    sys.path.insert(0, os.path.abspath(args.checkout))
    os.chdir(args.checkout)
    import chip_smoke as cs
    from batch3dmot_tpu_torch.models import init_params_, make_model
    from batch3dmot_tpu_torch.ops import cuda_build
    from batch3dmot_tpu_torch.ops.fused_mp import fused_mp_scores_plain
    from batch3dmot_tpu_torch.ops.fused_mp_train import fused_mp_train_scores

    cuda_build.build(["fused_mp", "fused_mp_train"])
    model = init_params_(make_model("mm"), torch.Generator().manual_seed(0)).cuda().eval()
    rng = np.random.default_rng(INPUT_SEED)
    out = {}
    for (n, e), windows in SPREAD_CASES:
        inputs = cs.random_inputs(rng, windows, n, e, model.node_dim, model.edge_dim, True)
        ct = torch.from_numpy(rng.uniform(-1.0, 1.0, (windows, e)).astype(np.float32)).cuda()
        m64 = copy.deepcopy(model).double()
        i64 = [t.double() if t is not None and t.is_floating_point() else t for t in inputs]
        _, g64 = cs.train_grads(m64, i64, ct.double(), 6, True, fused_mp_scores_plain)
        del m64, i64
        valid = inputs[-1]
        abs_sum = float(ct[valid].double().abs().sum())
        last = "edge_classifier.6.bias"
        readings = {"kernel": [], "plain": []}
        for rows in permuted(rng, inputs, ORDERS):
            x0, e0, att, src, dst, mask = inputs
            inp = (x0, reorder(e0, rows), reorder(att, rows), reorder(src, rows),
                   reorder(dst, rows), reorder(mask, rows))
            ct_o = reorder(ct, rows)
            want = {k: (reorder(r, rows) if k in ("de0", "datt") else r)
                    for k, r in g64.items()}
            for tag, fn in (("kernel", fused_mp_train_scores), ("plain", fused_mp_scores_plain)):
                _, g = cs.train_grads(model, inp, ct_o, 6, True, fn)
                rms = rms_readings(g, want)
                rms["last_bias_units"] = abs(float(g[last].double().sum() - g64[last].sum())) / (
                    2.0 ** -24 * abs_sum)
                readings[tag].append(rms)
                model.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        case = f"({n},{e}) x{windows}"
        spread = {}
        for k in (*g64, "last_bias_units"):
            kv = [r[k] for r in readings["kernel"]]
            pv = [r[k] for r in readings["plain"]]
            spread[k] = dict(kernel=kv, plain=pv,
                             ratio_first=kv[0] / pv[0] if pv[0] > 0 else float("inf"),
                             ratio_medians=float(np.median(kv) / np.median(pv))
                             if np.median(pv) > 0 else float("inf"))
        out[case] = dict(valid_edges=int(valid.sum()), cotangent_abs_sum=abs_sum, grads=spread)
        top = sorted(((k, v) for k, v in spread.items() if k != "last_bias_units"),
                     key=lambda kv: -kv[1]["ratio_first"])[:5]
        print(f"spread {case} in {args.checkout}: {ORDERS} orders; RMS from float64 "
              f"kernel / f32 plain in the given order (ratio), then each one's range over "
              f"the orders and the ratio of the medians:", flush=True)
        for k, v in top:
            print(f"  {k}: {v['kernel'][0]:.3e} / {v['plain'][0]:.3e} ({v['ratio_first']:.2f}); "
                  f"kernel {min(v['kernel']):.3e}-{max(v['kernel']):.3e}, plain "
                  f"{min(v['plain']):.3e}-{max(v['plain']):.3e}, medians "
                  f"{v['ratio_medians']:.2f}", flush=True)
        u = spread["last_bias_units"]
        print(f"  {last}: |x - f64| in units of 2^-24 x sum|cotangent| ({abs_sum:.6g}): "
              f"kernel {', '.join(f'{x:.4f}' for x in u['kernel'])}; plain "
              f"{', '.join(f'{x:.4f}' for x in u['plain'])}", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("part", choices=["seed", "spread"])
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--at", default="45,46,47,48,49")
    ap.add_argument("--steps-of", type=int, default=49)
    ap.add_argument("--checkout", default=os.path.join(HERE, ".."),
                    help=argparse.SUPPRESS)
    ap.add_argument("--other", default="")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("probe_backward_f64: no CUDA device", file=sys.stderr)
        return 2
    card = card_name()
    if args.part == "seed":
        out = seed_part(args)
        print(json.dumps(dict(card=card, **out)))
        return 1 if out["failures"] else 0
    out = {"this": spread_part(args)}
    if args.other:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "spread",
                               "--checkout", os.path.abspath(args.other)],
                              capture_output=True, text=True)
        print(proc.stdout[:-1].rsplit("\n", 1)[0] if proc.stdout else "", flush=True)
        if proc.returncode:
            print(proc.stderr[-3000:], file=sys.stderr)
            return 1
        out["other"] = json.loads(proc.stdout.strip().splitlines()[-1])["this"]
    print(json.dumps(dict(card=card, **out)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
