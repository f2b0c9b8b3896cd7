"""peak_device_gib: torch.cuda.max_memory_allocated over the window, GiB."""

from readers import peak_gib


def read(record: dict):
    return peak_gib(record) if record.get("loop") == "closed" else None
