"""PyTorch/CUDA port of ``distributed_llms_tpu``.

Mirrors the JAX package's layout (``core/``, ``models/``, ``ops/``,
``runtime/``, ``cli/``): each module's counterpart sits at the same path.
Plain tensor code is PyTorch; every TPU kernel on a ported path is a
hand-written Hopper kernel under ``ops/csrc/``, built at first use.  The
package imports ``torch`` and never ``jax`` or the JAX package.

Ported so far: paged, prefix-cached continuous batching of the
llama family behind the OpenAI-style HTTP server (``dlt-serve-torch``).
"""
