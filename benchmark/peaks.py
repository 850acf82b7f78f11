"""Published peaks of one NVIDIA H100 SXM (dense, no sparsity), the table of
the port's ``runtime/timing.py`` copied: HBM3 bytes/s and operations/s by
type. A share of a peak is stated against these, with the card's power
limit beside it (``nvidia-smi``)."""

PEAK = {"bytes": 3.35e12, "int8": 1979e12, "bf16": 989e12, "tf32": 494.7e12, "f32": 67e12}

# the peak that a configuration's compute type runs at: float32 with TF32
# off runs on the CUDA cores
PEAK_OF_DTYPE = {"float32": PEAK["f32"], "bfloat16": PEAK["bf16"]}
