"""``torch.cuda.max_memory_allocated`` over the window, on the fullest
card (GiB)."""


def read(record):
    peak = record.get("peak_bytes", {}).get("window")
    return None if not peak else peak / 2 ** 30
