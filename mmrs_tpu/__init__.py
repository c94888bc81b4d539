"""mmrs_tpu — Multi-Modal Retrieval System: Image Search and Data Governance.

A from-scratch JAX/XLA/Pallas framework providing the capabilities of the
reference system (chy980959830/Multi-Modal-Retrieval-System-Image-Search-and-
Data-Governance): CLIP-style text->image / image->image search, bilingual
(EN/CN) retrieval with threshold-union fusion, F1-optimal threshold
calibration, VLM cascade verification, few-shot Tip-Adapter(-F) adaptation,
and data-governance tooling (dedup, leakage removal, normalization, VQA
dataset generation) — rebuilt for an accelerator (an NVIDIA H100):

- Pallas kernels (Triton) for the hot ops: the cosine top-k gallery scan,
  tiled all-pairs similarity for semantic dedup, the IVF bucket probe.
- Jitted bf16 encoder towers (ViT-B/32, ViT-L/14, CLIP text, Taiyi RoBERTa).
- Gallery sharding + distributed top-k over a `jax.sharding.Mesh`
  (compiler-inserted collectives), instead of the reference's single-GPU batch streaming.
"""

__version__ = "0.1.0"

from mmrs_tpu import config  # noqa: F401
