"""proof_s: the closed loop's window, from the first request's start to
the last proof's end, over the proofs completed (tracegen and prove both:
a caller pays for both)."""

from readers import proven


def read(record: dict):
    if record.get("loop") != "closed" or not proven(record):
        return None
    start, end = record["window"]
    return (end - start) / len(proven(record))
