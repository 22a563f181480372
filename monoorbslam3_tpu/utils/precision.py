"""f32 matmul scoping for accuracy-critical geometry code.

On an NVIDIA GPU (Ampere and later) XLA runs f32 matmuls and einsums at
DEFAULT precision — and at HIGH — in TF32 on the tensor cores: 10-bit
mantissas, about 3e-4 relative error per product. That is fine for the
throughput kernels that choose their operand types explicitly (the +-1
bf16 Hamming matmul is exact; the BRIEF sampler's bf16 patch operand is
the reference's uint8 quantization), but it corrupts geometry: a camera
projection is ~O(300 px), so 3e-4 is ~0.1 px of noise on residuals whose
real magnitude is ~0.3 px, and a normal-equation sum in TF32 shifts the
LM optimum. On the H100, the one-hot sums of the BA assembly came out
with relative errors up to 3.4e-4 at DEFAULT and HIGH against float64,
and the two-view initializer's outputs moved visibly between DEFAULT and
HIGHEST, while the tracking, triangulation and fuse kernels did not move
(experiments/ba_assembly_probe.py --sums and experiments/main_path_probe.py
reproduce both).

`f32_matmuls` wraps a traced function so every matmul/einsum/conv created
inside defaults to Precision.HIGHEST (true f32). Explicitly-annotated
precisions inside the scope are unaffected, so deliberate bf16 kernels
keep their speed. Apply it UNDER jax.jit (the context must be active at
trace time)."""

from __future__ import annotations

import functools

import jax


def f32_matmuls(fn):
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)

    return wrapped
