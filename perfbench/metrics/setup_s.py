"""setup_s: seconds from process start until the measured window opens
(loading, weights, warm-up batches, the kernel library load)."""


def read(rec):
    return rec.get("setup_s")
