"""The decode steps' share of the card's peak: each step's roofline bound
(``counts.decode_step``: bytes over 3.35 TB/s bind) summed, over the
untraced window's seconds, in percent."""


def read(run: dict):
    w = run["window"]
    if "steps" not in w:
        return None
    return 100.0 * run["counts"]["step_bound_s"] / w["seconds"]
