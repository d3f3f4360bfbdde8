"""Share of the traced window in which the device waits on the training
loop's host stages: from one ``_run_steps`` call's last out copy to the
next call's first index copy (the fetch, the epoch's metrics, the return
to the caller, the next rows and their upload), timed by the program's
CUDA events."""


def _loop() -> dict:
    """The program's loop counters (``utils.profiling.loop_stats``): empty
    where it keeps none."""
    from batch3dmot_tpu_torch.utils import profiling

    return getattr(profiling, "loop_stats", dict)()


def read(v):
    s = _loop()
    if not s.get("steps") or "wait_device_s" not in s or v.trace["window_s"] <= 0:
        return None
    return 100.0 * s["wait_device_s"] / v.trace["window_s"]
