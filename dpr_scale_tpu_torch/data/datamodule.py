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
    batches for retrieval;
  * ``DistillDataModule`` — JSONL rows with teacher vectors ->
    distillation batches (``data.distill``).

Batches are built on one background thread (``utils.prefetch``), or with
``num_workers > 0`` in a forkserver pool of worker processes
(``data.parallel.WorkerPool``), each of which rebuilds a serial datamodule
from the spec; a batch is a pure function of its key either way, so both
give the same bytes.
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
        num_workers: int = 0,
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
        # workers rebuild this datamodule from the spec below
        self.num_workers = num_workers
        self._pool = None
        self._worker_spec = {
            "tokenizer": tokenizer.spec,
            "kwargs": dict(
                train_path=train_path, val_path=val_path, test_path=test_path,
                corpus_path=corpus_path, batch_size=batch_size,
                val_batch_size=val_batch_size, test_batch_size=test_batch_size,
                num_positive=num_positive, num_negative=num_negative,
                neg_ctx_sample=neg_ctx_sample, pos_ctx_sample=pos_ctx_sample,
                num_val_negative=num_val_negative, num_test_negative=num_test_negative,
                use_title=use_title, sep_token=sep_token, rel_sample=rel_sample,
                drop_last=drop_last, seed=seed, query_max_seq_len=query_max_seq_len,
                ctx_max_seq_len=ctx_max_seq_len,
            ),
        }

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
        """Assemble one batch by dataset indices (also the worker entry).
        ``reseed`` (a per-batch entropy tuple) pins the sampling RNG so the
        batch is a pure function of its key — see DPRExampleBuilder.reseed."""
        dataset = {
            "train": self.train_dataset,
            "eval": self.val_dataset,
            "test": self.test_dataset,
        }[stage]
        if reseed is not None:
            self.builder.reseed(list(reseed))
        rows = [dataset[int(i)] for i in idx]
        return self.batcher(self.builder.build_batch(rows, stage))

    def _get_pool(self):
        if self._pool is None:
            from dpr_scale_tpu_torch.data.parallel import WorkerPool

            self._pool = WorkerPool(self.num_workers, _rebuild_dense_dm, self._worker_spec)
        return self._pool

    def close(self):
        """Stop the worker processes, if any (the prefetch thread ends with
        its iterator)."""
        if self._pool is not None:
            self._pool.close()
            self._pool = None

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

        def keyed_batches():
            # resume support: slice the epoch order at the batch level and
            # offset the position in the RNG key, so batch `start_batch + i`
            # is byte-identical to the unskipped stream without paying
            # sampling/tokenization for the skipped prefix
            sliced = order[start_batch * batch_size :]
            for bi, idx in enumerate(
                self._batch_indices(sliced, batch_size, stage), start=start_batch
            ):
                # per-batch RNG key: batch content is a pure function of
                # (seed, epoch, stage, position), in the serial and the
                # worker paths alike
                yield stage, idx, (int(self.seed), int(epoch), stage_id, bi)

        if self.num_workers > 0:
            gen = self._get_pool().imap("build_batch_for", keyed_batches())
            return prefetch(gen, self.prefetch_batches)

        def gen():
            for args in keyed_batches():
                yield self.build_batch_for(*args)

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
        num_workers: int = 0,
    ):
        self.dataset = CSVDataset(passages_path)
        self.batcher = TextBatcher(tokenizer, use_title=use_title, sep_token=sep_token)
        self.batch_size = batch_size
        self.prefetch_batches = prefetch_batches
        self.num_workers = num_workers
        self._pool = None
        self._worker_spec = {
            "tokenizer": tokenizer.spec,
            "kwargs": dict(passages_path=passages_path, batch_size=batch_size,
                           use_title=use_title, sep_token=sep_token),
        }

    def __len__(self):
        return len(self.dataset)

    def passages_batch_for(self, lo: int, hi: int) -> Dict[str, np.ndarray]:
        """Build one padded batch from dataset rows [lo, hi) (also the
        worker entry)."""
        buf = [self.dataset[i] for i in range(lo, hi)]
        pad = self.batch_size - len(buf)
        out = self.batcher.passages(buf + [buf[-1]] * pad if pad else buf)
        out["pad_count"] = np.int32(pad)
        return out

    def close(self):
        if self._pool is not None:
            self._pool.close()
            self._pool = None

    def batches(
        self, shard: int = 0, num_shards: int = 1
    ) -> Iterator[Dict[str, np.ndarray]]:
        rows_range = contiguous_shard(len(self.dataset), shard, num_shards)
        spans = [
            (lo, min(lo + self.batch_size, rows_range.stop))
            for lo in range(rows_range.start, rows_range.stop, self.batch_size)
        ]
        if self.num_workers > 0:
            if self._pool is None:
                from dpr_scale_tpu_torch.data.parallel import WorkerPool

                self._pool = WorkerPool(self.num_workers, _rebuild_passages_dm, self._worker_spec)
            return prefetch(self._pool.imap("passages_batch_for", spans), self.prefetch_batches)

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


class DistillDataModule:
    """JSONL rows with teacher vectors -> distillation batches (the
    reference's DPRDistillTransform pipeline); train batches are keyed by
    (seed, epoch, position), so ``start_batch`` resumes the stream."""

    def __init__(
        self,
        tokenizer: HFTokenizer,
        train_path: Optional[str] = None,
        val_path: Optional[str] = None,
        test_path: Optional[str] = None,
        batch_size: int = 8,
        pos_ctx_sample: bool = True,
        drop_last: bool = True,
        seed: int = 0,
        prefetch_batches: int = 2,
    ):
        from dpr_scale_tpu_torch.data.distill import DistillBatcher, DistillExampleBuilder

        self.builder = DistillExampleBuilder(pos_ctx_sample=pos_ctx_sample, seed=seed)
        self.batcher = DistillBatcher(tokenizer)
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.seed = seed
        self.prefetch_batches = prefetch_batches
        opn = lambda p: MemoryMappedDataset(p) if p else None
        self.train_dataset = opn(train_path)
        self.val_dataset = opn(val_path)
        self.test_dataset = opn(test_path)

    def steps_per_epoch(self) -> int:
        n = len(self.train_dataset)
        return n // self.batch_size if self.drop_last else math.ceil(n / self.batch_size)

    def close(self):
        """Nothing to release (the prefetch thread ends with its iterator)."""

    def _iter(self, dataset, order, stage, epoch: int = 0, start_batch: int = 0):
        def gen():
            sliced = order[start_batch * self.batch_size :]
            for bi in range(0, len(sliced), self.batch_size):
                idx = sliced[bi : bi + self.batch_size]
                if stage == "train" and self.drop_last and len(idx) < self.batch_size:
                    return
                # per-batch RNG key: batches are pure functions of their
                # position, so skipping to start_batch reproduces the stream
                self.builder.reseed(
                    (int(self.seed), int(epoch), bi // self.batch_size + start_batch)
                )
                rows = [dataset[int(i)] for i in idx]
                yield self.batcher(self.builder.build_batch(rows, stage))

        return prefetch(gen(), self.prefetch_batches)

    def example_batch(self, stage: str = "train") -> Dict[str, np.ndarray]:
        dataset = self.train_dataset or self.test_dataset or self.val_dataset
        rows = [dataset[i % len(dataset)] for i in range(self.batch_size)]
        return self.batcher(self.builder.build_batch(rows, stage))

    def train_batches(self, epoch: int = 0, start_batch: int = 0):
        rng = np.random.default_rng(self.seed + epoch)
        return self._iter(
            self.train_dataset, rng.permutation(len(self.train_dataset)), "train", epoch,
            start_batch,
        )

    def val_batches(self):
        if self.val_dataset is None:
            return iter(())
        return self._iter(self.val_dataset, np.arange(len(self.val_dataset)), "eval")

    def test_batches(self):
        if self.test_dataset is None:
            return iter(())
        return self._iter(self.test_dataset, np.arange(len(self.test_dataset)), "test")


def _rebuild_dense_dm(spec: dict) -> DenseRetrieverDataModule:
    """Worker-side factory: a serial datamodule rebuilt from its spec."""
    tok = HFTokenizer(**spec["tokenizer"])
    return DenseRetrieverDataModule(tok, **spec["kwargs"], num_workers=0, prefetch_batches=0)


def _rebuild_passages_dm(spec: dict) -> PassagesDataModule:
    tok = HFTokenizer(**spec["tokenizer"])
    return PassagesDataModule(tok, **spec["kwargs"], num_workers=0, prefetch_batches=0)
