"""Tokens the window generated (batch x steps), over its seconds."""


def read(run: dict):
    w = run["window"]
    if "steps" not in w:
        return None
    return w["tokens"] / w["seconds"]
