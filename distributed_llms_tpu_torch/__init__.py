"""PyTorch/CUDA port of ``distributed_llms_tpu``.

Mirrors the JAX package's layout (``core/``, ``models/``, ``ops/``,
``runtime/``, ``cli/``): each module's counterpart sits at the same path.
Plain tensor code is PyTorch; every TPU kernel on a ported path is a
hand-written Hopper kernel under ``ops/csrc/``, built at first use.  The
package imports ``torch`` and never ``jax`` or the JAX package.

Ported so far: continuous batching of the llama family (paged with the
automatic prefix cache, int8 KV pages, or contiguous with sliding
windows) behind the OpenAI-style HTTP server (``dlt-serve-torch``), over
random preset weights or a shard store, with weight-only int8/int4
quantized serving of a quantized store; flash attention
(``attn_impl="flash"``: blockwise prefill at a model's full context) and
the training step (``runtime/train.py``).
"""
