"""The prefill calls' share of the card's peak: their roofline bounds
(``counts.prefill_call``: operations over 989 TFLOP/s, the router's over
67) summed, over the untraced window's seconds, in percent."""


def read(run: dict):
    w = run["window"]
    if "calls" not in w:
        return None
    return 100.0 * run["counts"]["step_bound_s"] / w["seconds"]
