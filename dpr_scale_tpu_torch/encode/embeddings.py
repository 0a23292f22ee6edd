"""Corpus / query embedding generation.

Counterpart of :mod:`dpr_scale_tpu.encode.embeddings`. Shard formats are
byte-compatible with the JAX package's: ``reps_{shard:04}.pkl`` is a pickled
numpy array (protocol 4), ``.npy`` is ``np.save``; ``manifest.json`` maps
shards to corpus row ranges and is updated under a file lock, so concurrent
shard jobs on one directory neither lose entries nor expose half-written
JSON.
"""
from __future__ import annotations

import fcntl
import json
import os
import pickle
from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch


def save_embedding_shard(path_prefix: str, embeddings: np.ndarray, fmt: str = "pickle") -> str:
    """Write one embedding shard; returns the file path."""
    if fmt == "pickle":
        path = path_prefix + ".pkl"
        with open(path, "wb") as f:
            pickle.dump(np.ascontiguousarray(embeddings), f, protocol=4)
    elif fmt == "npy":
        path = path_prefix + ".npy"
        np.save(path, np.ascontiguousarray(embeddings))
    else:
        raise ValueError(f"unknown embedding format {fmt!r}")
    return path


def load_embedding_shard(path: str) -> np.ndarray:
    """Read one shard: .npy, or .pkl holding a numpy array or torch tensor."""
    if path.endswith(".npy"):
        return np.load(path)
    with open(path, "rb") as f:
        try:
            obj = pickle.load(f)
        except pickle.UnpicklingError:
            f.seek(0)  # torch-tensor pickles (the reference's writer)
            obj = torch.load(f, map_location="cpu", weights_only=False)
    if isinstance(obj, torch.Tensor):
        obj = obj.float().numpy()
    return np.asarray(obj)


def _shard_names(ctx_embeddings_dir: str) -> List[str]:
    """The ``reps_*`` shard files of a directory, sorted by shard id; a
    rerank sidecar (``.rerank.npy``) is none of them."""
    return sorted(
        n
        for n in os.listdir(ctx_embeddings_dir)
        if n.startswith("reps_")
        and (n.endswith(".pkl") or n.endswith(".npy"))
        and not n.endswith(".rerank.npy")
    )


def load_embedding_shards(ctx_embeddings_dir: str) -> List[Tuple[str, np.ndarray]]:
    """All ``reps_*`` shards in a directory, sorted by shard id."""
    return [
        (n, load_embedding_shard(os.path.join(ctx_embeddings_dir, n)))
        for n in _shard_names(ctx_embeddings_dir)
    ]


class ShardRowReader:
    """Random row access over the ``reps_*`` shards of a directory without
    the fp32 corpus in RAM: the exact-rerank source of the quantised tiers
    (``MipsIndex.set_rerank``). ``.npy`` shards are memory-mapped; a
    ``.pkl`` shard gets an fp32 ``.rerank.npy`` sidecar, built once (peak RAM
    one shard) and reused while the pickle's (size, mtime) is unchanged. The
    JAX package's reader, sidecar format included."""

    def __init__(self, ctx_embeddings_dir: str):
        names = _shard_names(ctx_embeddings_dir)
        if not names:
            raise FileNotFoundError(f"no reps_* shards in {ctx_embeddings_dir}")
        self._maps: List[np.ndarray] = []
        offsets = [0]
        for n in names:
            path = os.path.join(ctx_embeddings_dir, n)
            m = np.load(path, mmap_mode="r") if n.endswith(".npy") else self._pkl_sidecar(path)
            self._maps.append(m)
            offsets.append(offsets[-1] + m.shape[0])
        self._offsets = np.asarray(offsets, np.int64)
        self.num_rows = int(self._offsets[-1])
        self.dim = int(self._maps[0].shape[1])

    @staticmethod
    def _pkl_sidecar(path: str) -> np.ndarray:
        side = path + ".rerank.npy"
        st = os.stat(path)
        fp_path = side + ".fp"
        fp = f"{st.st_size}:{int(st.st_mtime)}"
        if os.path.exists(side) and os.path.exists(fp_path):
            with open(fp_path) as f:
                if f.read() == fp:
                    return np.load(side, mmap_mode="r")
        arr = load_embedding_shard(path)
        mm = np.lib.format.open_memmap(side, mode="w+", dtype=np.float32, shape=arr.shape)
        mm[:] = arr
        mm.flush()
        del arr, mm
        with open(fp_path, "w") as f:
            f.write(fp)
        return np.load(side, mmap_mode="r")

    def __call__(self, ids: np.ndarray) -> np.ndarray:
        """Global row ids -> (M, D) fp32 rows (the ``set_rerank`` contract)."""
        ids = np.asarray(ids, np.int64)
        out = np.empty((ids.size, self.dim), np.float32)
        shard_of = np.searchsorted(self._offsets, ids, side="right") - 1
        for si in np.unique(shard_of):
            sel = shard_of == si
            out[sel] = self._maps[si][ids[sel] - self._offsets[si]]
        return out


class CorpusEncoder:
    """Drives one tower of a :class:`~dpr_scale_tpu_torch.models.encoder.BiEncoder`
    over token batches on ``device``.

    ``out_dtype=np.float16`` casts on the device before the fetch (half the
    device->host bytes and shard size); every shard reader upcasts.
    """

    def __init__(self, model, device, use_query_tower: bool = False, out_dtype=np.float32):
        self.device = torch.device(device)
        self.out_dtype = np.dtype(out_dtype)
        self._torch_out = torch.float16 if self.out_dtype == np.float16 else torch.float32
        self._tower = model.encode_query if use_query_tower else model.encode_context

    def encode(self, input_ids, attention_mask) -> torch.Tensor:
        """(B, L) int token ids and mask (numpy or tensors) -> (B, D) embeddings
        on the device, in ``out_dtype``. Runs under ``inference_mode`` on the
        calling thread (the mode is thread-local)."""
        with torch.inference_mode():
            ids = torch.as_tensor(input_ids).to(self.device)
            mask = torch.as_tensor(attention_mask).to(self.device)
            return self._tower(ids, mask).to(self._torch_out)

    def encode_batches(
        self, batches: Iterator[Dict[str, np.ndarray]]
    ) -> Tuple[np.ndarray, List[str]]:
        """Returns (embeddings (N, D), corpus_ids list). Padded tail rows
        (``pad_count``) are dropped. Up to two batches stay queued on the
        device while the host tokenizes the next one."""
        pending = []  # (device tensor, pad_count, ids)
        out: List[np.ndarray] = []
        ids: List[str] = []

        def drain(item):
            emb, pad, bids = item
            emb = emb.cpu().numpy().astype(self.out_dtype, copy=False)
            n = emb.shape[0] - int(pad)
            out.append(emb[:n])
            if bids is not None:
                ids.extend(list(bids)[:n])

        for batch in batches:
            emb = self.encode(batch["input_ids"], batch["attention_mask"])
            pending.append((emb, batch.get("pad_count", 0), batch.get("corpus_ids")))
            if len(pending) > 2:
                drain(pending.pop(0))
        for item in pending:
            drain(item)
        if not out:
            return np.zeros((0, 0), self.out_dtype), ids
        return np.concatenate(out, axis=0), ids

    def encode_to_dir(
        self,
        batches,
        output_dir: str,
        shard_id: int = 0,
        num_shards: int = 1,
        fmt: str = "pickle",
        corpus_offset: int = 0,
    ) -> str:
        """Encode one contiguous shard, write ``reps_{shard:04}`` and its
        ``manifest.json`` entry."""
        os.makedirs(output_dir, exist_ok=True)
        emb, _ids = self.encode_batches(batches)
        path = save_embedding_shard(
            os.path.join(output_dir, f"reps_{shard_id:04}"), emb, fmt
        )
        manifest_path = os.path.join(output_dir, "manifest.json")
        entry = {
            "file": os.path.basename(path),
            "rows": emb.shape[0],
            "dim": int(emb.shape[1]) if emb.ndim == 2 else 0,
            "corpus_offset": corpus_offset,
            "num_shards": num_shards,
        }
        with open(manifest_path + ".lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            manifest = {}
            if os.path.exists(manifest_path):
                with open(manifest_path) as f:
                    manifest = json.load(f)
            manifest[str(shard_id)] = entry
            tmp = manifest_path + f".tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(manifest, f, indent=1)
            os.replace(tmp, manifest_path)
        return path
