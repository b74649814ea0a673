"""How many times the rendering function's plan changed in the window
(compared after every ``render()``)."""


def read(rec):
    return rec["plan_changes"]
