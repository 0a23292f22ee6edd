"""DataModules: dataset + example builder + batcher -> batch iterators.

The port's copy of the two datamodules of ``dpr_scale_tpu/data/datamodule.py``
that its paths use; for the same files and seed they yield byte-equal numpy
batches (reference: dpr_scale/datamodule/dpr.py:162-479):

  * ``DenseRetrieverDataModule`` — JSONL train/val/test with per-stage
    negative counts, list-valued ``train_path`` and the docidx ``corpus_path``
    mode;
  * ``PassagesDataModule`` — corpus TSV -> context batches for embedding
    generation, with contiguous sharding;
  * ``QueriesDataModule`` — query file (CSV answers or TREC TSV) -> query
    batches for retrieval.

Batches are built on one background thread (``utils.prefetch``); the JAX
package's worker-process pool (``num_workers > 0``) is not ported.
"""
from __future__ import annotations

import math
from typing import Dict, Iterator, List, Optional, Sequence, Union

import numpy as np

from dpr_scale_tpu_torch.data.batching import DPRBatcher, TextBatcher
from dpr_scale_tpu_torch.data.datasets import (
    CSVDataset,
    MemoryMappedDataset,
    MultiSourceDataset,
    QueryCSVDataset,
    QueryTSVDataset,
)
from dpr_scale_tpu_torch.data.example import DPRExampleBuilder
from dpr_scale_tpu_torch.data.tokenize import HFTokenizer
from dpr_scale_tpu_torch.utils.prefetch import prefetch


def contiguous_shard(n: int, shard: int, num_shards: int) -> range:
    """Contiguous [start, end) rows for one shard — corpus order preserved
    so embedding shards concatenate back in corpus order (parity:
    ContiguousDistributedSamplerForTest, utils/utils.py:83-91)."""
    per = math.ceil(n / num_shards)
    start = shard * per
    return range(start, min(start + per, n))


class DenseRetrieverDataModule:
    def __init__(
        self,
        tokenizer: HFTokenizer,
        train_path: Union[str, Sequence[str], None] = None,
        val_path: Optional[str] = None,
        test_path: Optional[str] = None,
        corpus_path: Optional[str] = None,
        batch_size: int = 2,
        val_batch_size: int = 0,  # 0 -> batch_size
        test_batch_size: int = 0,
        num_positive: int = 1,
        num_negative: int = 7,
        neg_ctx_sample: bool = True,
        pos_ctx_sample: bool = False,
        num_val_negative: int = 7,
        num_test_negative: Optional[int] = None,
        use_title: bool = False,
        sep_token: Optional[str] = None,
        rel_sample: bool = False,
        drop_last: bool = True,
        seed: int = 0,
        prefetch_batches: int = 2,
        contiguous_chunks: int = 0,
        query_max_seq_len: Optional[int] = None,
        ctx_max_seq_len: Optional[int] = None,
    ):
        self.tokenizer = tokenizer
        corpus = MemoryMappedDataset(corpus_path, header=True) if corpus_path else None
        self.builder = DPRExampleBuilder(
            num_positive=num_positive,
            num_negative=num_negative,
            neg_ctx_sample=neg_ctx_sample,
            pos_ctx_sample=pos_ctx_sample,
            num_val_negative=num_val_negative,
            num_test_negative=num_test_negative,
            use_title=use_title,
            sep_token=sep_token if sep_token is not None else tokenizer.sep_token,
            rel_sample=rel_sample,
            corpus=corpus,
            seed=seed,
        )
        # shorter query padding (e.g. 32 tokens in the DRAGON recipes) cuts
        # query-tower FLOPs without touching context length
        self.batcher = DPRBatcher(
            tokenizer,
            query_max_seq_len=query_max_seq_len,
            ctx_max_seq_len=ctx_max_seq_len,
        )
        self.batch_size = batch_size
        self.val_batch_size = val_batch_size or batch_size
        self.test_batch_size = test_batch_size or self.val_batch_size
        self.drop_last = drop_last
        self.seed = seed
        self.prefetch_batches = prefetch_batches
        self.contiguous_chunks = contiguous_chunks

        def open_train(path):
            if path is None:
                return None
            if isinstance(path, (list, tuple)):
                return MultiSourceDataset(
                    [MemoryMappedDataset(p) for p in path], seed=seed
                )
            return MemoryMappedDataset(path)

        self.train_dataset = open_train(train_path)
        self.val_dataset = MemoryMappedDataset(val_path) if val_path else None
        self.test_dataset = MemoryMappedDataset(test_path) if test_path else None

    # ------------------------------------------------------------------ #

    def steps_per_epoch(self) -> int:
        n = len(self.train_dataset)
        return n // self.batch_size if self.drop_last else math.ceil(n / self.batch_size)

    def build_batch_for(
        self, stage: str, idx: Sequence[int], reseed=None
    ) -> Dict[str, np.ndarray]:
        """Assemble one batch by dataset indices. ``reseed`` (a per-batch
        entropy tuple) pins the sampling RNG so the batch is a pure function
        of its key — see DPRExampleBuilder.reseed."""
        dataset = {
            "train": self.train_dataset,
            "eval": self.val_dataset,
            "test": self.test_dataset,
        }[stage]
        if reseed is not None:
            self.builder.reseed(list(reseed))
        rows = [dataset[int(i)] for i in idx]
        return self.batcher(self.builder.build_batch(rows, stage))

    def close(self):
        """Nothing to release: batches are built on a prefetch thread that
        ends with its iterator (kept for the JAX datamodule's interface)."""

    def _batch_indices(self, order, batch_size, stage):
        for lo in range(0, len(order), batch_size):
            idx = order[lo : lo + batch_size]
            if stage == "train" and self.drop_last and len(idx) < batch_size:
                return
            yield [int(i) for i in idx]

    def _iter(
        self, dataset, order, batch_size, stage, epoch: int = 0, start_batch: int = 0
    ) -> Iterator[Dict[str, np.ndarray]]:
        stage_id = {"train": 0, "eval": 1, "test": 2}[stage]

        def gen():
            # resume support: slice the epoch order at the batch level and
            # offset the position in the RNG key, so batch `start_batch + i`
            # is byte-identical to the unskipped stream without paying
            # sampling/tokenization for the skipped prefix
            sliced = order[start_batch * batch_size :]
            for bi, idx in enumerate(
                self._batch_indices(sliced, batch_size, stage), start=start_batch
            ):
                # per-batch RNG key: batch content is a pure function of
                # (seed, epoch, stage, position)
                yield self.build_batch_for(
                    stage, idx, (int(self.seed), int(epoch), stage_id, bi)
                )

        return prefetch(gen(), self.prefetch_batches)

    def train_batches(
        self, epoch: int = 0, start_batch: int = 0
    ) -> Iterator[Dict[str, np.ndarray]]:
        n = len(self.train_dataset)
        if self.contiguous_chunks > 1:
            # node-contiguous sampling for mmap page locality: shuffle
            # WITHIN contiguous chunks only (parity:
            # ContiguousDistributedSampler, reference utils/utils.py:31-80,
            # seeded by seed+epoch+chunk)
            parts = []
            for c, rows in enumerate(
                np.array_split(np.arange(n), self.contiguous_chunks)
            ):
                rng = np.random.default_rng(self.seed + epoch * 131 + c)
                parts.append(rng.permutation(rows))
            order = np.concatenate(parts)
        else:
            rng = np.random.default_rng(self.seed + epoch)
            order = rng.permutation(n)
        return self._iter(
            self.train_dataset, order, self.batch_size, "train", epoch, start_batch
        )

    def val_batches(self) -> Iterator[Dict[str, np.ndarray]]:
        if self.val_dataset is None:
            return iter(())
        order = np.arange(len(self.val_dataset))
        return self._iter(self.val_dataset, order, self.val_batch_size, "eval")

    def test_batches(self) -> Iterator[Dict[str, np.ndarray]]:
        if self.test_dataset is None:
            return iter(())
        order = np.arange(len(self.test_dataset))
        return self._iter(self.test_dataset, order, self.test_batch_size, "test")


class PassagesDataModule:
    """Corpus TSV -> fixed-size context batches with corpus ids.

    The final batch is padded up to ``batch_size`` (with ``pad_count``
    reported) so every encode batch has one shape.
    """

    def __init__(
        self,
        tokenizer: HFTokenizer,
        passages_path: str,
        batch_size: int = 128,
        use_title: bool = True,
        sep_token: Optional[str] = None,
        prefetch_batches: int = 2,
    ):
        self.dataset = CSVDataset(passages_path)
        self.batcher = TextBatcher(tokenizer, use_title=use_title, sep_token=sep_token)
        self.batch_size = batch_size
        self.prefetch_batches = prefetch_batches

    def __len__(self):
        return len(self.dataset)

    def passages_batch_for(self, lo: int, hi: int) -> Dict[str, np.ndarray]:
        """Build one padded batch from dataset rows [lo, hi)."""
        buf = [self.dataset[i] for i in range(lo, hi)]
        pad = self.batch_size - len(buf)
        out = self.batcher.passages(buf + [buf[-1]] * pad if pad else buf)
        out["pad_count"] = np.int32(pad)
        return out

    def close(self):
        """Nothing to release (kept for the JAX datamodule's interface)."""

    def batches(
        self, shard: int = 0, num_shards: int = 1
    ) -> Iterator[Dict[str, np.ndarray]]:
        rows_range = contiguous_shard(len(self.dataset), shard, num_shards)
        spans = [
            (lo, min(lo + self.batch_size, rows_range.stop))
            for lo in range(rows_range.start, rows_range.stop, self.batch_size)
        ]

        def gen():
            for lo, hi in spans:
                yield self.passages_batch_for(lo, hi)

        return prefetch(gen(), self.prefetch_batches)


class QueriesDataModule:
    """Query file -> fixed-size query batches (CSV answers or TREC TSV).

    The final batch is padded up to ``batch_size`` with its last row
    repeated, ``pad_count`` reporting how many."""

    def __init__(
        self,
        tokenizer: HFTokenizer,
        queries_path: str,
        batch_size: int = 128,
        trec_format: bool = False,
        prefetch_batches: int = 2,
    ):
        self.dataset = (
            QueryTSVDataset(queries_path) if trec_format else QueryCSVDataset(queries_path)
        )
        self.batcher = TextBatcher(tokenizer)
        self.batch_size = batch_size
        self.prefetch_batches = prefetch_batches

    def __len__(self):
        return len(self.dataset)

    def rows(self) -> List[dict]:
        return [self.dataset[i] for i in range(len(self.dataset))]

    def batches(self) -> Iterator[Dict[str, np.ndarray]]:
        def gen():
            buf: List[dict] = []
            for i in range(len(self.dataset)):
                buf.append(self.dataset[i])
                if len(buf) == self.batch_size:
                    out = self.batcher.queries(buf)
                    out["pad_count"] = np.int32(0)
                    yield out
                    buf = []
            if buf:
                pad = self.batch_size - len(buf)
                out = self.batcher.queries(buf + [buf[-1]] * pad)
                out["pad_count"] = np.int32(pad)
                yield out

        return prefetch(gen(), self.prefetch_batches)
