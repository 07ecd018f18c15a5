"""serve.cond_graph_replay_pct.device_paced: ``serve.cond_graph_replay_pct``
in the serving cells that the device paces, which move
``pages_per_s.device_paced`` (PERF.md, section 2)."""

from perfbench.harness import reader

read = reader("serve.cond_graph_replay_pct")
