"""Feature pre-materialization: feats.scp → one memmap pack.

A copy of ``pkr_tpu/data/materialize.py`` for the port, which imports
nothing of ``pkr_tpu``.

The reference ships scripts/prepare_data.py (scp → per-utterance torch.save
files + lengths.pkl, kept commented-out in run.sh:198-204) as an optional
faster input path.  Here the equivalent is a single flat float32/float16
memmap plus a JSON index — one file, O(1) open cost, and the training
loader reads crops with zero deserialization.  (For uint8 CM-quantized
storage use pkr_tpu_torch.data.device_cache, which keeps the codes in device memory.)
"""

from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import numpy as np


def materialize(scp_path: str, out_prefix: str, dtype: str = "float16") -> str:
    """Pack every matrix behind feats.scp into <out_prefix>.bin + .json.

    dtype: 'float32' | 'float16' (fbank features span ~[-20, 25]; fp16 keeps
    ~3 decimal digits, plenty under CM's own uint8 quantization).
    Returns the index path.
    """
    from pkr_tpu_torch.io import kaldi_ark

    if dtype not in ("float32", "float16"):
        raise ValueError(
            f"dtype {dtype!r} unsupported: a raw cast would corrupt "
            "features (negative fbank values wrap in integer dtypes); use "
            "'float32'/'float16', or data.device_cache for CM quantization")
    entries = []
    offset = 0
    np_dtype = np.dtype(dtype)
    bin_path = out_prefix + ".bin"
    idx_path = out_prefix + ".json"
    os.makedirs(os.path.dirname(os.path.abspath(bin_path)), exist_ok=True)
    with open(bin_path, "wb") as f:
        for utt, mat in kaldi_ark.read_mat_scp(scp_path):
            arr = np.ascontiguousarray(mat, dtype=np_dtype)
            f.write(arr.tobytes())
            entries.append({"utt": utt, "rows": int(arr.shape[0]),
                            "cols": int(arr.shape[1]), "offset": offset})
            offset += arr.nbytes
    with open(idx_path, "w") as f:
        json.dump({"dtype": dtype, "entries": entries}, f)
    return idx_path


class MaterializedSource:
    """FeatureSource-compatible reader over a materialized pack (memmap)."""

    def __init__(self, index_path: str):
        idx = json.load(open(index_path))
        self.dtype = np.dtype(idx["dtype"])
        self.entries = idx["entries"]
        self.utts = [e["utt"] for e in self.entries]
        bin_path = index_path[: -len(".json")] + ".bin"
        if self.entries:
            self._mm = np.memmap(bin_path, dtype=self.dtype, mode="r")
        else:  # an empty pack can't be mmap'd; behave like an empty scp
            self._mm = np.empty((0,), self.dtype)
        self._item = self.dtype.itemsize

    def __len__(self):
        return len(self.entries)

    def dims(self, i: int) -> Tuple[int, int]:
        e = self.entries[i]
        return e["rows"], e["cols"]

    def read(self, i: int) -> np.ndarray:
        e = self.entries[i]
        start = e["offset"] // self._item
        mat = self._mm[start:start + e["rows"] * e["cols"]]
        out = np.asarray(mat, np.float32).reshape(e["rows"], e["cols"])
        # float32 packs view the read-only memmap zero-copy; hand callers a
        # writable array like FeatureSource.read does
        return out if out.flags.writeable else out.copy()

    def read_crop_t(self, i: int, row_start: int, n_rows: int,
                    out: Optional[np.ndarray] = None) -> np.ndarray:
        e = self.entries[i]
        R, C = e["rows"], e["cols"]
        start = e["offset"] // self._item
        if row_start + n_rows <= R:
            block = self._mm[start + row_start * C:start + (row_start + n_rows) * C]
            crop = np.asarray(block, np.float32).reshape(n_rows, C).T
        else:
            idx = (row_start + np.arange(n_rows)) % R
            full = self._mm[start:start + R * C].reshape(R, C)
            crop = np.asarray(full[idx], np.float32).T
        if out is not None:
            out[:] = crop
            return out
        return np.ascontiguousarray(crop)

    def cache_in_memory(self) -> None:  # memmap already page-cached
        pass
