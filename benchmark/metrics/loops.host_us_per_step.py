"""The host's own time a loop step, in microseconds: the self time of the
port's loop.drain spans (without the eager first steps and the captures)
less the host's waits on the device (loop_sync_wait_s: each step's sync and
the wait before each capture), over the steps run (loop_steps), summed over
the window's images. While the host spends it, the card waits for the next
replay."""
UNIT = "us"
LAYER = "graphed loops"
MOVES = "samples_per_s"


def read(run):
    stats = [im["stats"] for im in run.images]
    if not stats or any("spans" not in s for s in stats):
        return None
    steps = sum(s.get("loop_steps", 0) for s in stats)
    if steps <= 0:
        return None
    drain_self = sum(s["spans"]["loop.drain"][2] for s in stats if "loop.drain" in s["spans"])
    wait = sum(s.get("loop_sync_wait_s", 0.0) for s in stats)
    return 1e6 * (drain_self - wait) / steps
