"""peak_device_gib.service: torch.cuda.max_memory_allocated over the stream's window, GiB."""

from readers import peak_gib


def read(record: dict):
    return peak_gib(record) if record.get("loop") == "stream" else None
