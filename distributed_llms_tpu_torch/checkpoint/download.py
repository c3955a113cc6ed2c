"""Model acquisition for the port (PyTorch port of
``distributed_llms_tpu/checkpoint/download.py``): the local-directory leg
only.

The port fetches nothing over a network: a checkpoint is a local directory
(a HuggingFace snapshot already on disk: ``config.json`` plus
``.safetensors`` or ``.bin`` weights, tokenizer files optional), and any
other name is refused with the fix.
"""

from __future__ import annotations

import os


def fetch_model(model_id_or_path: str) -> str:
    """Return the local directory holding the checkpoint."""
    if os.path.isdir(model_id_or_path):
        return model_id_or_path
    raise RuntimeError(
        f"{model_id_or_path!r} is not a local directory, and the port fetches "
        "nothing from a model hub: download the checkpoint yourself and pass "
        "its local directory (config.json plus .safetensors or .bin weights)"
    )
