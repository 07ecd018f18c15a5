"""k1_padded_launches.device_paced: K1 launches a batch whose head dim has
no kernel instance of its own and is zero-padded to the next (the
program's ``attention.launches_padded``, summed over head dims), made in
the profiled stretch of a traced run, over the batches served there
(``perfbench/traffic/serve_chain.py``).  0 where every head dim has its
own instance; None without a profiled stretch or without the counter."""


def read(rec):
    padded = (rec.get("profile") or {}).get("k1_padded")
    if padded is None or not rec.get("batches_profiled"):
        return None
    return sum(padded.values()) / rec["batches_profiled"]
