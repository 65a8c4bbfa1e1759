"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
its 700 W limit): the denominators of every roofline and ``mfu`` share."""

HBM_BPS = 3.35e12                 # device memory, bytes/s
FLOPS = {"bf16": 989e12,          # tensor cores, bf16 operands
         "tf32": 495e12,
         "fp32": 67e12}           # outside the tensor cores (TF32 off)

# a configuration's stated precision → the peak its convs run at: bf16c3
# computes its convs as bf16 tensor-core passes
PRECISION_PEAK = {"bf16": "bf16", "bf16c": "bf16", "bf16c3": "bf16",
                  "mixed": "fp32", "fp32": "fp32", None: "fp32"}


def peak_flops(precision) -> float:
    return FLOPS[PRECISION_PEAK[precision]]
