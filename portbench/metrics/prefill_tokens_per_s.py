"""Prompt tokens of every prefill call the window issued, over the
window's seconds (the queued calls' drain included)."""


def read(run: dict):
    w = run["window"]
    if "calls" not in w:
        return None
    return w["tokens"] / w["seconds"]
