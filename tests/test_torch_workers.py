"""The port's worker-process pool (``data.parallel.WorkerPool``) against its
serial path and the JAX package's datamodules, on the CPU; mirrors
tests/test_example_batching.py's worker tests. Tolerance: byte for byte.

The workers start by forkserver and rebuild the datamodule (and its
tokenizer, from ``HFTokenizer.spec``) from a spec; each hides every CUDA
device before it builds anything."""
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

from dpr_scale_tpu.data.datamodule import DenseRetrieverDataModule as JaxDenseDataModule
from dpr_scale_tpu.data.tokenize import HFTokenizer as JaxTokenizer
from dpr_scale_tpu_torch.data.datamodule import DenseRetrieverDataModule, PassagesDataModule
from dpr_scale_tpu_torch.data.tokenize import HFTokenizer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONF = os.path.join(ROOT, "conf")


def _same(got, want):
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert set(a) == set(b)
        for k in a:
            assert np.asarray(a[k]).tobytes() == np.asarray(b[k]).tobytes(), k


def test_passages_workers_match_serial(dpr10_tsv, tiny_bert_dir):
    tok = HFTokenizer(tiny_bert_dir, max_seq_len=16)
    serial = PassagesDataModule(tok, dpr10_tsv, batch_size=4)
    par = PassagesDataModule(tok, dpr10_tsv, batch_size=4, num_workers=2)
    try:
        _same(list(par.batches()), list(serial.batches()))
        assert len(list(par.batches(1, 2))) == 2  # a shard, through the same pool
    finally:
        par.close()
    assert par._pool is None


def test_dense_workers_match_serial_and_jax(dpr10_jsonl, tiny_bert_dir):
    """Eval and train batches (sampling included: per-batch RNG keys) from
    the workers equal the serial path's, and the JAX datamodule's, with the
    resume skip."""
    kwargs = dict(train_path=dpr10_jsonl, val_path=dpr10_jsonl, batch_size=3, num_negative=2,
                  num_val_negative=1, seed=0)
    tok = HFTokenizer(tiny_bert_dir, max_seq_len=16)
    serial = DenseRetrieverDataModule(tok, **kwargs)
    par = DenseRetrieverDataModule(tok, num_workers=2, **kwargs)
    jax_dm = JaxDenseDataModule(JaxTokenizer(tiny_bert_dir, max_seq_len=16), **kwargs)
    try:
        _same(list(par.val_batches()), list(serial.val_batches()))
        for epoch in (0, 1):
            want = list(jax_dm.train_batches(epoch))
            _same(list(par.train_batches(epoch)), want)
            _same(list(par.train_batches(epoch, start_batch=1)), want[1:])
        _same(list(par.train_batches(0)), list(serial.train_batches(0)))
    finally:
        par.close()


def test_tokenizer_spec_rebuilds_an_equal_tokenizer(tiny_bert_dir):
    """The wrapper holds a threading.local and cannot be pickled; its spec
    can, and rebuilds a tokenizer giving the same ids."""
    tok = HFTokenizer(tiny_bert_dir, max_seq_len=10, pad_to_multiple=4)
    again = HFTokenizer(**pickle.loads(pickle.dumps(tok.spec)))
    texts = ["who wrote a book", "what city"]
    for a, b in zip(tok(texts), again(texts)):
        assert a.tobytes() == b.tobytes()


def test_cli_generate_embeddings_with_workers_writes_the_serial_shard(tiny_bert_dir, dpr10_tsv,
                                                                      tmp_path):
    """``datamodule.num_workers`` no longer raises: the CLI with 2 workers
    writes the shard the serial run writes, byte for byte."""
    from dpr_scale_tpu_torch.cli import generate_embeddings

    shards = {}
    for workers in (0, 2):
        out = tmp_path / f"w{workers}"
        generate_embeddings.main([
            "--config", os.path.join(CONF, "tiny_smoke.yaml"), "--device", "cpu",
            f"task.transform.model_path={tiny_bert_dir}", "task.model.vocab_size=32",
            f"datamodule.passages_path={dpr10_tsv}", f"task.ctx_embeddings_dir={out}",
            "datamodule.encode_batch_size=4", f"datamodule.num_workers={workers}"])
        shards[workers] = (out / "reps_0000.pkl").read_bytes()
    assert shards[0] == shards[2]


@pytest.mark.parametrize("closed", [True, False], ids=["closed", "left_open"])
def test_no_process_outlives_a_program_that_used_workers(closed):
    """A program that started a pool leaves no process behind when it exits,
    whether it closed the pool or not: the forkserver's server and the
    resource tracker would otherwise outlive it as orphans. Nothing it
    started (run under ``setsid``) is left the moment it has exited, and
    its exit is quiet."""
    code = ("from dpr_scale_tpu_torch.data.parallel import WorkerPool\n"
            "WorkerPool.preload = ()\n"  # the tokenizer stack plays no part here
            "pool = WorkerPool(2, str, 'ab')\n"
            "assert list(pool.imap('__add__', [('c',), ('d',)])) == ['abc', 'abd']\n"
            + ("pool.close()\n" if closed else ""))
    child = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, start_new_session=True,
                             stderr=subprocess.PIPE, text=True)
    _, err = child.communicate(timeout=120)
    left = []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            if os.getsid(int(pid)) == child.pid:
                left.append(pid)
        except OSError:
            pass
    assert child.returncode == 0, err
    assert left == []
    assert "leaked" not in err and "Traceback" not in err, err
