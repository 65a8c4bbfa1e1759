"""Rank 0's device ms a step in NCCL kernels (`parallel/mesh.py`:
`allreduce_grads`, `global_sum`). Moves `train_images_per_s.dp`."""


def read(trace, cell):
    return trace.per_unit(sum(e - b for n, b, e, _ in trace.kernels()
                              if "nccl" in n.lower()) / 1e6)
