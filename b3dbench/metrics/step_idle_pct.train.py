"""Share of the traced window in which the device idles inside the
replayed steps: the device time from each ``_run_steps`` call's first
index copy to its last out copy (the program's CUDA events) less the
window's busy time, so the CUDA graph's inter-kernel gaps and the gaps
around each step's copies."""


def _loop() -> dict:
    """The program's loop counters (``utils.profiling.loop_stats``): empty
    where it keeps none."""
    from batch3dmot_tpu_torch.utils import profiling

    return getattr(profiling, "loop_stats", dict)()


def read(v):
    s = _loop()
    if not s.get("steps") or "step_device_s" not in s or v.trace["window_s"] <= 0:
        return None
    return 100.0 * (s["step_device_s"] - v.trace["busy_s"]) / v.trace["window_s"]
