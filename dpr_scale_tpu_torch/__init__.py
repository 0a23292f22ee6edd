"""dpr_scale_tpu_torch — the PyTorch / CUDA port of dpr_scale_tpu for NVIDIA Hopper.

It mirrors the JAX package's layout and names, imports ``torch`` and never
``jax``, and holds hand-written CUDA kernels (``csrc/``) where the JAX
package has Pallas kernels. Ported: dense serving (the bert_base encoder
with fused attention, and the verified-exact MIPS index with the
group-count pass, behind the corpus encoder and HTTP server CLIs), dense
training on one GPU (the bi-encoder task, AdamW and the training CLI, with
the attention's dropout and backward as kernels), the fused-FFN
configuration of both, and CITADEL serving (the multi-vector encoder, the
inverted expert index and its device search with the posting gather-score
kernels, behind the multivec emission and CITADEL retrieval CLIs).
"""

__version__ = "0.1.0"
