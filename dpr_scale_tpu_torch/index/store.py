"""Prequantised int8 index store: build once, serve many times.

Counterpart of :mod:`dpr_scale_tpu.index.store`, in the same format, so a
store built by either package loads and serves in the other. A retrieval
run that builds its index from the fp32 ``reps_*`` shards reads every shard
and quantises every row at each start (about 64 GB of reads for the 21M x
768 north-star corpus); the store keeps what ``MipsIndex.add`` computes for
``method="int8"`` (column-equalised, per-row symmetric int8 and its scales)
as raw ``.npy`` blocks plus a manifest:

  store_dir/
    manifest.json            # dim, blocks, pad geometry, source fingerprint
    block_0000.q8.npy        # (n_pad, D) int8
    block_0000.sc.npy        # (n_pad,)  fp32 per-row scales
    block_0000.col.npy       # (D,)      fp32 per-column equalisation
    ...

A cold start reads the manifest: the host tier is opened with
``mmap_mode="r"``, so its bytes page in during the first streamed search.
The manifest fingerprints the source shards (name, size, mtime), so a
stale store is rebuilt rather than served. Blocks are padded to
``pad_multiple`` rows (8192 by default, which any device count up to 64
divides into 128-row multiples); pad rows hold q8 = 0 and scale 1 and are
masked by ``n_valid``, as in ``MipsIndex.add``. numpy only: building needs
no device.
"""
from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

import numpy as np

from dpr_scale_tpu_torch.encode.embeddings import _shard_names, load_embedding_shard

MANIFEST = "manifest.json"
STORE_VERSION = 1
DEFAULT_PAD_MULTIPLE = 8192  # rows: 128-row multiples on up to 64 devices
QUANT_CHUNK = 65_536  # rows quantised at a time, a thread each


def _source_fingerprint(ctx_embeddings_dir: str) -> List[dict]:
    out = []
    for n in _shard_names(ctx_embeddings_dir):
        st = os.stat(os.path.join(ctx_embeddings_dir, n))
        out.append({"name": n, "size": st.st_size, "mtime": st.st_mtime})
    return out


def _write_block(store_dir: str, bi: int, parts: List[np.ndarray], pad_multiple: int) -> dict:
    """Quantise the rows of ``parts`` (in order) into block ``bi``. A
    column-max pass, then QUANT_CHUNK rows at a time (a thread each): the
    per-row arithmetic of ``MipsIndex._quantize_int8_host`` in the same
    order, at the memory of a few chunks instead of several fp32 copies of
    the block."""
    n = sum(p.shape[0] for p in parts)
    D = parts[0].shape[1]
    n_pad = (n + pad_multiple - 1) // pad_multiple * pad_multiple
    col = np.zeros((D,), np.float32)
    for part in parts:
        np.maximum(col, np.abs(part).max(axis=0), out=col)
    col[col == 0.0] = 1.0
    q8 = np.zeros((n_pad, D), np.int8)
    sc = np.ones((n_pad,), np.float32)  # pad rows: q8 0, scale 1

    def quantise(part, lo, row0):
        x = part[lo : lo + QUANT_CHUNK] / col[None, :]
        s = np.abs(x).max(axis=1) / 127.0
        s[s == 0.0] = 1.0
        q8[row0 : row0 + x.shape[0]] = np.clip(np.rint(x / s[:, None]), -127, 127)
        sc[row0 : row0 + x.shape[0]] = s

    jobs, row0 = [], 0
    for part in parts:
        for lo in range(0, part.shape[0], QUANT_CHUNK):
            jobs.append((part, lo, row0))
            row0 += min(QUANT_CHUNK, part.shape[0] - lo)
    # chunks are independent and numpy releases the GIL: a thread a core
    with ThreadPoolExecutor(min(len(jobs), os.cpu_count() or 1)) as pool:
        list(pool.map(lambda job: quantise(*job), jobs))
    for suffix, arr in (("q8", q8), ("sc", sc), ("col", col)):
        np.save(os.path.join(store_dir, f"block_{bi:04}.{suffix}.npy"), arr)
    return {"n_valid": int(n), "n_pad": int(n_pad)}


def build_int8_store(
    ctx_embeddings_dir: str,
    store_dir: str,
    max_block_rows: int = 2_000_000,
    pad_multiple: int = DEFAULT_PAD_MULTIPLE,
) -> dict:
    """Quantise every ``reps_*`` shard into ``store_dir``, one shard read at
    a time, re-chunked into blocks of at most ``max_block_rows`` rows in
    corpus order. Returns the manifest."""
    fp = _source_fingerprint(ctx_embeddings_dir)
    if not fp:
        raise FileNotFoundError(f"no reps_* shards in {ctx_embeddings_dir}")
    os.makedirs(store_dir, exist_ok=True)
    blocks: List[dict] = []
    dim: Optional[int] = None
    pending: List[np.ndarray] = []  # rows carried across shard boundaries
    pending_rows = 0

    def flush(final: bool):
        nonlocal pending_rows
        while pending_rows >= max_block_rows or (final and pending_rows > 0):
            take = min(max_block_rows, pending_rows)
            parts, got = [], 0
            while got < take:
                head = pending[0]
                if head.shape[0] <= take - got:
                    parts.append(pending.pop(0))
                    got += head.shape[0]
                else:
                    parts.append(head[: take - got])
                    pending[0] = head[take - got :]
                    got = take
            pending_rows -= take
            blocks.append(_write_block(store_dir, len(blocks), parts, pad_multiple))

    for entry in fp:
        emb = np.asarray(
            load_embedding_shard(os.path.join(ctx_embeddings_dir, entry["name"])), np.float32
        )
        dim = int(emb.shape[1]) if dim is None else dim
        if emb.shape[1] != dim:
            raise ValueError(f"shard {entry['name']} has dim {emb.shape[1]}, the others {dim}")
        pending.append(emb)
        pending_rows += emb.shape[0]
        flush(final=False)
    flush(final=True)
    manifest = {
        "version": STORE_VERSION,
        "method": "int8",
        "dim": dim,
        "pad_multiple": pad_multiple,
        "blocks": blocks,
        "source": fp,
    }
    with open(os.path.join(store_dir, MANIFEST), "w") as f:
        json.dump(manifest, f)
    return manifest


def store_is_current(store_dir: str, ctx_embeddings_dir: str) -> bool:
    """True iff ``store_dir`` holds a manifest built from exactly the
    ``reps_*`` shards now in ``ctx_embeddings_dir``."""
    path = os.path.join(store_dir, MANIFEST)
    if not os.path.exists(path):
        return False
    try:
        with open(path) as f:
            manifest = json.load(f)
    except (OSError, ValueError):
        return False
    return (
        manifest.get("version") == STORE_VERSION
        and manifest.get("source") == _source_fingerprint(ctx_embeddings_dir)
    )


def load_int8_store(index, store_dir: str, device_rows: Optional[int] = None) -> None:
    """Fill an int8 :class:`~dpr_scale_tpu_torch.index.mips.MipsIndex` from a
    store. A host-resident index takes every block as a host tier; any other
    places blocks on its device (``add_device_quantized``) until the
    optional ``device_rows`` budget is spent, and the rest become host tiers
    (``add_host_quantized``) read with ``mmap_mode="r"``, which stream
    through the device at each search."""
    from dpr_scale_tpu_torch.index.mips import HostBlock

    with open(os.path.join(store_dir, MANIFEST)) as f:
        manifest = json.load(f)
    if manifest["method"] != "int8" or index.method != "int8":
        raise ValueError(
            f"an int8 store ({manifest['method']!r}) loads into an int8 index, "
            f"not {index.method!r}"
        )
    ndev = 1  # the port's index lives on one device
    if manifest["pad_multiple"] % (ndev * 128) != 0:
        raise ValueError(
            f"store pad_multiple {manifest['pad_multiple']} does not cover a "
            f"{ndev}-device mesh (needs a multiple of {ndev * 128})"
        )
    placed = 0
    for bi, b in enumerate(manifest["blocks"]):
        path = os.path.join(store_dir, f"block_{bi:04}")
        q8 = np.load(f"{path}.q8.npy", mmap_mode="r")
        sc = np.load(f"{path}.sc.npy")
        col = np.load(f"{path}.col.npy")
        if not index.host_resident and (device_rows is None or placed + b["n_pad"] <= device_rows):
            block = HostBlock(q8, sc, col)  # uploaded through the index's pinned ring
            dev = index._stream.take(index._stream.start(block), block)
            index.add_device_quantized(dev.rows, dev.row_scales, n_valid=b["n_valid"],
                                       col_scales=dev.col_scales)
            placed += b["n_pad"]
        else:
            index.add_host_quantized(q8, sc, n_valid=b["n_valid"], col_scales=col)
