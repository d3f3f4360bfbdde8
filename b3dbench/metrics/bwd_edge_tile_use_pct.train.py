"""Share of the training backward's edge tiles that ran: the 32-row tiles
of ``edge_bwd_kernel`` that hold a live edge row (up to each window's last
row with an index or a cotangent) over the tiles launched, over every
layer, as the program counts them on the card from the traced stretch's
first training call. The rest return at once."""


def _loop() -> dict:
    """The program's loop counters (``utils.profiling.loop_stats``): empty
    where it keeps none."""
    from batch3dmot_tpu_torch.utils import profiling

    return getattr(profiling, "loop_stats", dict)()


def read(v):
    s = _loop()
    if not s.get("bwd_tiles"):
        return None
    return 100.0 * s["bwd_tiles_run"] / s["bwd_tiles"]
