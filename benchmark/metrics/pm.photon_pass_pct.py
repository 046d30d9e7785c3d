"""The photon pass's share of the window's image walls (render()'s
stats["photon_pass_s"]: emission, the host grid build and the upload)."""
UNIT = "%"
LAYER = "photon mapper passes"
MOVES = "samples_per_s"


def read(run):
    passes = [im["stats"].get("photon_pass_s") for im in run.images]
    walls = sum(im["wall"] for im in run.images)
    if not passes or any(p is None for p in passes) or walls <= 0:
        return None
    return 100.0 * sum(passes) / walls
