"""One rule for choosing between a hand-written kernel and its XLA form.

Every op that has a Pallas kernel takes `impl=`:

  - "auto":             the measured choice on the GPU (`GPU_CHOICE`), the
                        XLA form on every other backend;
  - "pallas":           the kernel, compiled for the GPU through Triton; on
                        a backend that cannot compile it this raises;
  - "pallas_interpret": the kernel run by the Pallas interpreter (tests on
                        the CPU); only when asked for by name;
  - "xla":              the plain jax.numpy form, which is also the oracle.

`GPU_CHOICE` records which form won on an H100 at the benchmark's shapes
(PERF.md, "Findings"). A kernel that loses there is removed, not kept
behind a switch.
"""

from __future__ import annotations

import jax

IMPLS = ("auto", "pallas", "pallas_interpret", "xla")

# kernel name -> the form "auto" takes on the GPU
GPU_CHOICE = {
    "topk": "pallas",
    "first_match": "pallas",
    "ivf_probe": "pallas",
}


def resolve_impl(kernel: str, impl: str) -> str:
    """The concrete form ("pallas" | "pallas_interpret" | "xla") for
    `kernel` under `impl` on the default backend."""
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r} (one of {IMPLS})")
    backend = jax.default_backend()
    if impl == "auto":
        return GPU_CHOICE[kernel] if backend == "gpu" else "xla"
    if impl == "pallas" and backend != "gpu":
        raise ValueError(
            f"impl='pallas' for {kernel!r} needs a GPU (backend is "
            f"{backend!r}); use 'pallas_interpret' or 'xla'")
    return impl
