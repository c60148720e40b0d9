"""The benchmark of the PyTorch / CUDA port (``nvidia_terraform_modules_tpu_torch``).

One process runs one cell once: ``python3 -m portbench.run --workload
<cell> --seed <n> --seconds <s> --trace <0|1>``. Cells, configurations,
traffic mixes, traffic kinds and per-layer metrics are files of their own,
found by name (:mod:`portbench.harness`). Nothing here imports JAX or the
JAX package; the reference (:mod:`portbench.reference`) imports nothing of
the port.
"""
