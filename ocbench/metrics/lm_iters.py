"""LM: iterations a job."""


def read(record):
    lm = record.get("lm") or {}
    if not lm.get("iterations") or not record.get("jobs"):
        return None
    return lm["iterations"] / record["jobs"]
