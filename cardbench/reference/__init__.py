"""Plain PyTorch references that decide each cell's ``correct``.

Each module here recomputes, from the fields the benchmark made, what the
system under test should have written back, with the arithmetic written
out op by op in plain ``torch`` (no kernel of the port, nothing imported
from ``radler_tpu_torch``).  A module is chosen by the configuration's
``reference`` key and provides ``run(config, psfs, field, frequencies,
weights, dtype)``, returning ``(residual, model, iterations)``.  With
``dtype=torch.bfloat16`` it computes the control: the same algorithm with
its state held in the nearest precision below the configuration's float32.
"""
