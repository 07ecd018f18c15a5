"""pages_per_s: pages completed in the window over the window's seconds."""


def read(rec):
    if not rec.get("window_s") or "pages" not in rec:
        return None
    return rec["pages"] / rec["window_s"]
