"""setup_s: from the start of run.py to the window's start: imports, the
kernels' and native library's build or load, the statement maker, warm-up."""


def read(record: dict):
    return record.get("setup_s")
