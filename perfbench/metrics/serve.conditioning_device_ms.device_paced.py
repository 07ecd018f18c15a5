"""serve.conditioning_device_ms.device_paced:
``serve.conditioning_device_ms`` in the serving cells that the device
paces, which move ``pages_per_s.device_paced`` (PERF.md, section 2)."""

from perfbench.harness import reader

read = reader("serve.conditioning_device_ms")
