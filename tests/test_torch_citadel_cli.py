"""The port's CITADEL CLIs end to end on the CPU at a tiny size: multivec
emission -> inverted-index shards -> host / device-index retrieval -> TREC
and DPR-JSON output, and the query-side embedding emission.

The device index with fp32 postings must rank as the host index does, its
scores within 1e-4 (the JAX CLI test's tolerance); with bf16 postings the
scores stay within 1e-2 relative.
"""
import json
import os
import pickle

import numpy as np
import pytest

from dpr_scale_tpu_torch.cli import citadel_retrieval, generate_multivec_embeddings

CONF = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "conf")


@pytest.fixture(scope="module")
def citadel_setup(tmp_path_factory, tiny_bert_dir):
    d = tmp_path_factory.mktemp("torch_citadel_cli")
    words = list("abcdefghij")
    with open(d / "passages.tsv", "w") as f:
        f.write("id\ttext\ttitle\n")
        for i in range(12):
            w = words[i % len(words)]
            f.write(f"p{i}\t{w} {w} book {w}\tcity {i % 3}\n")
    with open(d / "queries.tsv", "w") as f:
        for i in range(5):
            f.write(f"q{i}\twhat {words[i]} book\n")
    base = [
        "--config", os.path.join(CONF, "tiny_smoke.yaml"), "--device", "cpu",
        f"task.transform.model_path={tiny_bert_dir}", "task.model.vocab_size=32",
        "task.transform.max_seq_len=12", "task.type=multivec", "task.variant=citadel",
        "task.tok_projection_dim=8", "task.cls_projection_dim=8", "task.add_cls=true",
        "task.query_topk=1", "task.context_topk=2",
        f"datamodule.passages_path={d}/passages.tsv", f"datamodule.test_path={d}/queries.tsv",
        "datamodule.trec_format=true", "datamodule.encode_batch_size=4",
    ]
    stats = generate_multivec_embeddings.main(base + [
        f"task.ctx_embeddings_dir={d}/cit_index", "task.shard=0", "task.num_shards=1"])
    assert stats["num_postings"] > 0
    return d, base + [f"task.ctx_embeddings_dir={d}/cit_index", "task.topk=8"]


def _trec(path):
    out = {}
    for line in open(path):
        qid, _q0, doc, _rank, score, _tag = line.split()
        out.setdefault(qid, []).append((doc, float(score)))
    return out


def _assert_same_run(want, got, tol):
    """One query's ranked (doc, score) lists as {doc: score} maps: the ranked
    scores within ``tol``, every shared doc's score within ``tol``, and a doc
    in only one list within ``tol`` of that list's last score (the passages
    repeat, so equal scores tie and the two sorts order ties differently)."""
    np.testing.assert_allclose([s for _d, s in got], [s for _d, s in want], rtol=0, atol=tol)
    w, g = dict(want), dict(got)
    for doc in w.keys() & g.keys():
        assert abs(w[doc] - g[doc]) <= tol, doc
    for doc in w.keys() ^ g.keys():
        score = w.get(doc, g.get(doc))
        assert score <= min(want[-1][1], got[-1][1]) + tol, doc


def test_citadel_cli_host_vs_device_index(citadel_setup):
    d, common = citadel_setup
    assert os.path.isdir(d / "cit_index" / "expert_0000") and (d / "cit_index" / "cls_0000.pkl").exists()
    citadel_retrieval.main(common + [f"task.output_trec_path={d}/host.trec",
                                     f"task.output_path={d}/host.json"])
    citadel_retrieval.main(common + ["task.device_index=true",
                                     "task.device_index_dtype=float32",
                                     f"task.output_trec_path={d}/dev.trec"])
    citadel_retrieval.main(common + ["task.device_index=true",
                                     f"task.output_trec_path={d}/bf16.trec"])
    host, dev, bf16 = (_trec(f"{d}/{n}.trec") for n in ("host", "dev", "bf16"))
    assert host.keys() == dev.keys() == bf16.keys() and len(host) == 5
    for q in host:
        _assert_same_run(host[q], dev[q], 1e-4)
        scale = max(abs(s) for _d, s in host[q])
        _assert_same_run(host[q], bf16[q], 1e-2 * scale)
    payload = json.load(open(d / "host.json"))
    assert [p["id"] for p in payload] == [f"q{i}" for i in range(5)]
    assert len(payload[0]["ctxs"]) == 8 and {"id", "title", "text", "score"} == set(
        payload[0]["ctxs"][0])


def test_citadel_cli_query_embedding_emission(citadel_setup):
    d, common = citadel_setup
    out_dir = d / "qemb"
    citadel_retrieval.main(common + [f"task.query_emb_output_dir={out_dir}",
                                     f"task.output_trec_path={d}/qemb.trec"])
    repr_ = pickle.load(open(out_dir / "query_repr.pkl", "rb"))
    weight = pickle.load(open(out_dir / "query_weight.pkl", "rb"))
    qids = pickle.load(open(out_dir / "query_id.pkl", "rb"))
    cls = pickle.load(open(out_dir / "query_cls.pkl", "rb"))
    L = repr_.shape[1]
    assert repr_.shape == (5, L, 8) and L <= 12
    assert weight.shape == (5, L, 1) and cls.shape == (5, 8)
    assert list(qids) == [f"q{i}" for i in range(5)]
    assert np.isfinite(repr_).all() and np.isfinite(cls).all()


def test_citadel_cli_refusals(citadel_setup):
    """A missing params export is refused. (``task.expert_parallel``, refused
    naming ROADMAP A12 until it was ported, runs:
    tests/test_torch_expert_parallel.py.)"""
    _d, common = citadel_setup
    with pytest.raises(FileNotFoundError, match="no params export"):
        citadel_retrieval.main(common + ["task.checkpoint_path=/no/such/ckpt"])
