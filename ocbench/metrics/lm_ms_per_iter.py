"""LM: ms an LM iteration, over every `lm.solve` / `lm.solve_batch` call (a
batched solve's lanes run in lockstep and count once), to the solve's end."""


def read(record):
    lm = record.get("lm") or {}
    if not lm.get("iterations"):
        return None
    return 1e3 * lm["seconds"] / lm["iterations"]
