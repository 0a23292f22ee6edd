"""The port's own host layer (dpr_scale_tpu_torch.{config,data,utils}) against
the JAX package's modules it copies: the same configs from the same files
and overrides, and byte-equal numpy batches from the same files and seed."""
import glob
import os

import numpy as np
import pytest

from dpr_scale_tpu.config import load_config as jax_load_config
from dpr_scale_tpu.config import parse_overrides as jax_parse_overrides
from dpr_scale_tpu.data.datamodule import DenseRetrieverDataModule as JaxDenseDM
from dpr_scale_tpu.data.datamodule import PassagesDataModule as JaxPassagesDM
from dpr_scale_tpu.data.datamodule import QueriesDataModule as JaxQueriesDM
from dpr_scale_tpu.data.datamodule import contiguous_shard as jax_contiguous_shard
from dpr_scale_tpu.data.datasets import CSVDataset as JaxCSVDataset
from dpr_scale_tpu.data.datasets import QueryCSVDataset as JaxQueryCSV
from dpr_scale_tpu.data.datasets import QueryTSVDataset as JaxQueryTSV
from dpr_scale_tpu.retrieve import writers as jax_writers
from dpr_scale_tpu.data.tokenize import HFTokenizer as JaxTokenizer
from dpr_scale_tpu.utils.native import scan_line_offsets as jax_scan
from dpr_scale_tpu_torch.config import load_config, parse_overrides
from dpr_scale_tpu_torch.data.datamodule import (
    DenseRetrieverDataModule,
    PassagesDataModule,
    QueriesDataModule,
    contiguous_shard,
)
from dpr_scale_tpu_torch.data.datasets import CSVDataset, QueryCSVDataset, QueryTSVDataset
from dpr_scale_tpu_torch.retrieve import writers
from dpr_scale_tpu_torch.data.tokenize import HFTokenizer
from dpr_scale_tpu_torch.utils import native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(os.path.relpath(p, REPO) for p in glob.glob(os.path.join(REPO, "conf", "*.yaml")))
OVERRIDES = ["task.model.fused_ffn=true", "trainer.max_steps=10", "task.optim.lr=1e-3",
             "datamodule.train_path=[a.jsonl,b.jsonl]", "task.new.key=", "seed=3"]


@pytest.mark.parametrize("overrides", [[], OVERRIDES], ids=["plain", "overrides"])
@pytest.mark.parametrize("path", CONFIGS)
def test_load_config_equals_jax(path, overrides):
    want = jax_load_config(os.path.join(REPO, path), overrides)
    got = load_config(os.path.join(REPO, path), overrides)
    assert got == want
    assert got.task.get("model") == want.task.get("model")  # attribute access


def test_every_config_was_compared():
    assert "conf/nq.yaml" in CONFIGS and "conf/tiny_smoke.yaml" in CONFIGS
    assert len(CONFIGS) == len(glob.glob(os.path.join(REPO, "conf", "*.yaml"))) >= 10


def test_parse_overrides_equals_jax():
    args = OVERRIDES + ["a.b=1e-3", "a.c=yes", "a.d=[1, 2]", "a.e=null"]
    assert parse_overrides(args) == jax_parse_overrides(args)
    with pytest.raises(ValueError, match="key=value"):
        parse_overrides(["no_equals_sign"])


def _assert_batches_equal(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for key in w:
            assert g[key].dtype == w[key].dtype, key
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)


@pytest.mark.parametrize("with_title", [True, False])
def test_dense_datamodule_batches_equal_jax(tiny_bert_dir, dpr10_jsonl, with_title):
    """Sampled negatives (train), fixed ones (eval/test), dummy padding,
    an epoch other than 0 and a resume skip: byte-equal numpy batches."""
    kw = dict(train_path=dpr10_jsonl, val_path=dpr10_jsonl, test_path=dpr10_jsonl,
              batch_size=3, num_negative=2, num_val_negative=3, num_test_negative=4,
              use_title=with_title, seed=7)
    port = DenseRetrieverDataModule(HFTokenizer(tiny_bert_dir, max_seq_len=16), **kw)
    ref = JaxDenseDM(JaxTokenizer(tiny_bert_dir, max_seq_len=16), **kw)
    assert port.steps_per_epoch() == ref.steps_per_epoch() == 3
    for epoch, start in ((0, 0), (1, 0), (1, 2)):
        _assert_batches_equal(port.train_batches(epoch, start), ref.train_batches(epoch, start))
    _assert_batches_equal(port.val_batches(), ref.val_batches())
    _assert_batches_equal(port.test_batches(), ref.test_batches())


def test_dense_datamodule_multi_file_and_docidx_corpus_equal_jax(tiny_bert_dir, dpr10_jsonl,
                                                                 tmp_path):
    corpus = tmp_path / "corpus.tsv"
    corpus.write_text("id\ttext\ttitle\n" + "".join(
        f'{i}\t"quoted\ttext {i}"\ttitle {i}\n' for i in range(5)))
    rows = tmp_path / "docidx.jsonl"
    rows.write_text("".join(
        '{"question": "who %d", "positive_ctxs": [{"docidx": %d}], '
        '"hard_negative_ctxs": [{"docidx": %d}]}\n' % (i, i % 5, (i + 2) % 5) for i in range(6)))
    kw = dict(train_path=[dpr10_jsonl, str(rows)], val_path=str(rows), corpus_path=str(corpus),
              batch_size=2, num_negative=1, num_val_negative=1, use_title=True,
              contiguous_chunks=2)
    port = DenseRetrieverDataModule(HFTokenizer(tiny_bert_dir, max_seq_len=16), **kw)
    ref = JaxDenseDM(JaxTokenizer(tiny_bert_dir, max_seq_len=16), **kw)
    _assert_batches_equal(port.train_batches(0), ref.train_batches(0))
    _assert_batches_equal(port.val_batches(), ref.val_batches())


@pytest.mark.parametrize("shard,num_shards", [(0, 1), (1, 3), (2, 3)])
def test_passages_datamodule_batches_equal_jax(tiny_bert_dir, dpr10_tsv, shard, num_shards):
    """Contiguous shards, the padded last batch and its pad_count, corpus ids."""
    port = PassagesDataModule(HFTokenizer(tiny_bert_dir, max_seq_len=12), dpr10_tsv, batch_size=3)
    ref = JaxPassagesDM(JaxTokenizer(tiny_bert_dir, max_seq_len=12), dpr10_tsv, batch_size=3)
    assert len(port) == len(ref) == 10
    _assert_batches_equal(port.batches(shard, num_shards), ref.batches(shard, num_shards))
    assert contiguous_shard(10, shard, num_shards) == jax_contiguous_shard(10, shard, num_shards)


def test_tokenizer_and_csv_dataset_equal_jax(tiny_bert_dir, dpr10_tsv):
    texts = ["who wrote the book", "", "title " * 40, "a b c"]
    for kw in ({"max_seq_len": 12}, {"max_seq_len": 32, "pad_to_multiple": 8}):
        got, want = HFTokenizer(tiny_bert_dir, **kw)(texts), JaxTokenizer(tiny_bert_dir, **kw)(texts)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == np.int32
            np.testing.assert_array_equal(g, w)
    port, ref = CSVDataset(dpr10_tsv), JaxCSVDataset(dpr10_tsv)
    assert [port[i] for i in range(len(port))] == [ref[i] for i in range(len(ref))]
    assert port.columns == ref.columns == ["id", "text", "title"]


@pytest.mark.parametrize("data", [b"", b"a", b"a\n", b"a\nbb\n\nccc", b"\n\n", b"x\ny\n" * 1000])
def test_scan_line_offsets_equals_jax_native_and_numpy(data, monkeypatch):
    want = jax_scan(data, len(data))
    np.testing.assert_array_equal(native.scan_line_offsets(data, len(data)), want)
    monkeypatch.setattr(native, "_load", lambda: None)  # the numpy fallback
    got = native.scan_line_offsets(data, len(data))
    assert got.dtype == np.uint64
    np.testing.assert_array_equal(got, want)


def _query_files(tmp_path):
    csv = tmp_path / "queries.csv"
    csv.write_text("who wrote the book\t['a', 'b']\nwhere\t[malformed\nno answers\n"
                   '"quoted\tquestion"\t["x"]\nlast one\t[]\n')
    tsv = tmp_path / "queries.tsv"
    tsv.write_text("q1\twho wrote the book\nq2\twhere is it\nq3\n" + "".join(
        f"q{i}\tquestion number {i}\n" for i in range(4, 9)))
    return str(csv), str(tsv)


def test_query_datasets_equal_jax(tmp_path):
    csv, tsv = _query_files(tmp_path)
    for port, ref in ((QueryCSVDataset(csv), JaxQueryCSV(csv)),
                      (QueryTSVDataset(tsv), JaxQueryTSV(tsv))):
        assert len(port) == len(ref) > 0
        assert [port[i] for i in range(len(port))] == [ref[i] for i in range(len(ref))]
    assert QueryCSVDataset(csv)[1] == {"question": "where", "answers": ["[malformed"]}
    assert QueryTSVDataset(tsv)[2] == {"id": "q3", "question": ""}


@pytest.mark.parametrize("trec_format", [True, False])
def test_queries_datamodule_batches_equal_jax(tiny_bert_dir, tmp_path, trec_format):
    """Full batches, the padded last batch and its pad_count, the rows."""
    csv, tsv = _query_files(tmp_path)
    path = tsv if trec_format else csv
    port = QueriesDataModule(HFTokenizer(tiny_bert_dir, max_seq_len=12), path, batch_size=3,
                             trec_format=trec_format)
    ref = JaxQueriesDM(JaxTokenizer(tiny_bert_dir, max_seq_len=12), path, batch_size=3,
                       trec_format=trec_format)
    assert len(port) == len(ref) and port.rows() == ref.rows()
    _assert_batches_equal(port.batches(), ref.batches())
    assert int(list(port.batches())[-1]["pad_count"]) == (-len(port)) % 3


def test_writers_write_the_jax_bytes(tmp_path):
    questions = [{"question": "q one", "answers": ["a"], "id": "x1"}, {"question": "q two"}]
    results = [[{"id": "7", "title": "t", "text": "b", "score": 1.5}],
               [{"id": "3", "title": "", "text": "c", "score": -0.25},
                {"id": "x1", "title": "", "text": "d", "score": -1.0}]]
    for mod, tag in ((writers, "port"), (jax_writers, "jax")):
        mod.write_dpr_json(str(tmp_path / f"{tag}.json"), questions, results)
        for ignore in (False, True):
            mod.write_trec_run(str(tmp_path / f"{tag}_{ignore}.trec"), ["x1", "1"],
                               [["7", "x1"], ["3"]], [[1.5, 0.5], [-0.25]],
                               ignore_identical_ids=ignore)
    for name in ("{}.json", "{}_False.trec", "{}_True.trec"):
        port = (tmp_path / name.format("port")).read_bytes()
        assert port == (tmp_path / name.format("jax")).read_bytes() and port
