"""One flat npz for every stateful artifact: a built pipeline's arrays and a
chain run's state.

The layout is the JAX package's (``utils/checkpoint.py`` there): the arrays
as ``leaf_0``, ``leaf_1``, ... in a fixed order and ``__meta__``, a JSON
document stored as UTF-8 bytes in a uint8 array, written by
``np.savez_compressed``. A file written by one side loads on the other.

The port has no pytrees, so the structure a file is read into is an
*exemplar*: the ordered list of ``(name, shape, dtype)`` of its leaves
(``shape`` None accepts any shape). The caller that writes a kind of file
owns its exemplar, and that list is the one place its leaf order is written
down. Loading casts each leaf to the exemplar's dtype, as the reference
does.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

Exemplar = Sequence[Tuple[str, Optional[tuple], Any]]


def np_dtype(dtype: torch.dtype) -> np.dtype:
    """The NumPy dtype of a torch dtype (an exemplar's entry)."""
    return torch.empty((), dtype=dtype).numpy().dtype


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def save_checkpoint(path, leaves: Sequence, meta: Optional[Dict[str, Any]] = None) -> None:
    """Write ``leaves`` (tensors or arrays, in the exemplar's order) and
    ``meta`` to one compressed npz at ``path``."""
    arrays = {f"leaf_{i}": _host(a) for i, a in enumerate(leaves)}
    arrays["__meta__"] = np.frombuffer(json.dumps(meta or {}).encode(), dtype=np.uint8)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **arrays)


def read_meta(path) -> Dict[str, Any]:
    """A checkpoint's ``__meta__`` document ({} if it has none)."""
    with np.load(path) as z:
        return json.loads(bytes(z["__meta__"]).decode()) if "__meta__" in z else {}


def load_checkpoint(path, exemplar: Exemplar) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    """({name: array} for the exemplar's leaves, meta). Leaf i of the file is
    the exemplar's entry i, cast to its dtype; a shape that differs from a
    given one raises."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode()) if "__meta__" in z else {}
        out = {}
        for i, (name, shape, dtype) in enumerate(exemplar):
            a = z[f"leaf_{i}"]
            if shape is not None and tuple(a.shape) != tuple(shape):
                raise ValueError(f"{path}: leaf_{i} ({name}) has shape {a.shape}, expected {tuple(shape)}")
            out[name] = a.astype(np.dtype(dtype))
    return out, meta
