"""The expert-parallel CITADEL device search of the port
(``DeviceExpertIndex(mesh=...)``, ``task.expert_parallel``,
``serve_citadel.expert_parallel``) against the port's single-device search
and the JAX package's ``DeviceExpertIndex`` on its 8-device CPU mesh.

The port's "mesh" is a list of devices (``parallel.mesh.get_mesh``); here 8
and 3 (an uneven split) shards of the CPU device, as the JAX tests force 8
CPU devices. The corpus is 5,000 docs, so only the first three of 8 column
shards own real columns (tests/test_inverted_index.py:265), with posting
lists in two buckets and repeated docs (runs); queries route to experts of
several shards, with zero-weight and masked tokens. With the streamed group
shrunk to one expert the experts spread over every shard; at its default
size they all land on the first, and every other shard is empty. Scores
within rtol 1e-5 of the single-device search (fp32 sums in another order)
and 1e-4 of JAX's, the same docs where the score is positive (random
vectors: no ties); JAX's mesh search always takes the dense combine, so
against the sorted one (no CLS, ``sorted_combine_min_docs`` lowered) the
docs agree where the score is positive. The CLI writes the same TREC file
with ``task.expert_parallel`` as without and as the JAX CLI's mesh(8) run;
``/search_citadel`` answers alike.
"""
import json
import os
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpr_scale_tpu.index import inverted as jinv
from dpr_scale_tpu.index import inverted_device as jdev
from dpr_scale_tpu.parallel import get_mesh as jax_get_mesh
from dpr_scale_tpu_torch.index import inverted as tinv
from dpr_scale_tpu_torch.index import inverted_device as tdev
from dpr_scale_tpu_torch.parallel import mesh

CONF = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "conf")
NUM_DOCS, D, CLS_DIM, N_EXPERTS, K = 5000, 8, 4, 48, 20


def _corpus(seed=0):
    """(port host index, JAX host index, queries) over the same postings."""
    rng = np.random.default_rng(seed)
    port = tinv.InvertedExpertIndex(dim=D, num_docs=NUM_DOCS)
    ref = jinv.InvertedExpertIndex(dim=D, num_docs=NUM_DOCS)
    for e in range(N_EXPERTS):
        n = int(rng.integers(20, 128) if e % 6 else rng.integers(129, 400))
        ids = rng.integers(0, NUM_DOCS, size=n).astype(np.int64)  # repeats: runs
        w = rng.random(n).astype(np.float32)
        v = rng.normal(size=(n, D)).astype(np.float32)
        port.experts[e] = tinv._ExpertPostings(ids, w, v)
        ref.experts[e] = jinv._ExpertPostings(ids, w, v)
    port.cls = ref.cls = rng.normal(size=(NUM_DOCS, CLS_DIM)).astype(np.float32)
    B, T = 4, 6
    ids = rng.integers(0, N_EXPERTS, size=(B, T, 2)).astype(np.int64)
    ids[0, 0, 1] = -1
    weights = rng.random((B, T, 2)).astype(np.float32)
    weights[1, 2, 0] = 0.0
    mask = np.ones((B, T), np.int64)
    mask[3, 4:] = 0
    query = {"expert_ids": ids, "expert_weights": weights, "attention_mask": mask,
             "expert_repr": rng.normal(size=(B, T, D)).astype(np.float32),
             "cls_repr": rng.normal(size=(B, CLS_DIM)).astype(np.float32)}
    return port, ref, query


@pytest.fixture(scope="module")
def corpus():
    port, ref, query = _corpus()
    jax_runs = {}
    for cls in (True, False):
        q = query if cls else {k: v for k, v in query.items() if k != "cls_repr"}
        index = jdev.DeviceExpertIndex.from_host_index(ref, dtype=jnp.float32,
                                                       mesh=jax_get_mesh(8))
        if not cls:
            index.cls = None
        jax_runs[cls] = index.search(q, topk=K)
    return port, query, jax_runs


def _dense(scores, rows):
    out = np.zeros((len(scores), NUM_DOCS), np.float32)
    for b in range(len(scores)):
        keep = rows[b] >= 0
        out[b, rows[b][keep]] = scores[b][keep]
    return out


def _same(got, want, rtol):
    """Scores within ``rtol`` as {doc: score} vectors; the ranked docs
    equal where the score is positive."""
    np.testing.assert_allclose(_dense(*got), _dense(*want), rtol=rtol, atol=1e-6)
    pos = want[0] > 0
    np.testing.assert_array_equal(got[1][pos], want[1][pos])
    assert pos.sum() > len(pos)  # most ranks hold a scored doc


def _indexes(port, query, ndev, combine):
    single = tdev.DeviceExpertIndex.from_host_index(port, dtype="float32", device="cpu")
    sharded = tdev.DeviceExpertIndex.from_host_index(port, dtype="float32",
                                                     mesh=mesh.get_mesh("cpu", ndev))
    q = query if combine == "cls" else {k: v for k, v in query.items() if k != "cls_repr"}
    if combine == "sorted":
        single.sorted_combine_min_docs = sharded.sorted_combine_min_docs = 0
    return single, sharded, q


@pytest.mark.parametrize("combine", ["cls", "dense", "sorted"])
@pytest.mark.parametrize("ndev", [8, 3])
def test_expert_parallel_equals_single_device_and_jax(corpus, ndev, combine, monkeypatch):
    """Experts spread over every shard (a streamed group of one expert);
    the dense combine with and without CLS, and the sorted combine."""
    monkeypatch.setattr(tdev, "STREAM_CHUNK", 2048)
    port, query, jax_runs = corpus
    single, sharded, q = _indexes(port, query, ndev, combine)
    assert sharded.ndev == ndev
    assert all(b["epd"] < len(b["experts"]) for b in sharded.buckets.values())  # spread
    want = single.search(q, topk=K)
    got = sharded.search(q, topk=K)
    _same(got, want, 1e-5)
    _same(got, jax_runs[combine == "cls"], 1e-4)
    shards = {shard for _b, _n, _s, shard in sharded.last_plan}
    assert len(shards) > 1 and {s for _b, _n, s, _sh in sharded.last_plan} == {"serial"}
    assert sharded.latency["shard_split_time"] > 0 and sharded.latency["search_time"] > 0
    nt, NT = sharded._tiles()
    assert nt % ndev == 0 and sum(i * NT // ndev < NUM_DOCS for i in range(ndev)) == 3
    s2, r2 = sharded.search(q, topk=K, as_numpy=False)
    assert isinstance(s2, torch.Tensor)
    np.testing.assert_array_equal(r2.numpy(), got[1])


@pytest.mark.parametrize("combine", ["cls", "sorted"])
def test_experts_on_one_shard_leave_the_others_empty(corpus, combine):
    """At the default streamed group every bucket's experts fit the first
    shard's block: the other seven shards hold padding only and receive no
    entries, and the search is unchanged."""
    port, query, jax_runs = corpus
    single, sharded, q = _indexes(port, query, 8, combine)
    for b in sharded.buckets.values():
        assert b["epd"] >= len(b["experts"])
        assert all((s["run_doc"] < 0).all() for s in b["shards"][1:])
    got = sharded.search(q, topk=K)
    _same(got, single.search(q, topk=K), 1e-5)
    _same(got, jax_runs[combine == "cls"], 1e-4)
    assert {shard for _b, _n, _s, shard in sharded.last_plan} == {0}


def test_expert_parallel_streamed_scorer(corpus, monkeypatch):
    """STREAM_MODE="on": each shard scores its slot-sorted entries with the
    streamed scorer (its plain version on the CPU), as one device would."""
    monkeypatch.setattr(tdev, "STREAM_CHUNK", 2048)
    monkeypatch.setattr(tdev, "STREAM_MODE", "on")
    port, query, _ = corpus
    single, sharded, q = _indexes(port, query, 3, "cls")
    _same(sharded.search(q, topk=K), single.search(q, topk=K), 1e-5)
    assert {s for _b, _n, s, _sh in sharded.last_plan} == {"streamed"}
    assert {sh for _b, _n, _s, sh in sharded.last_plan} == {0, 1, 2}


def test_expert_parallel_layout(corpus, monkeypatch):
    """Each bucket's expert axis padded to a multiple of ndev x the streamed
    group, shard i holding the single-device slots [i * epd, (i + 1) * epd);
    the CLS plane padded to the column grid and cut by doc rows; the
    routing tables keep global slots."""
    monkeypatch.setattr(tdev, "STREAM_CHUNK", 4096)
    port, _query, _ = corpus
    single = tdev.DeviceExpertIndex.from_host_index(port, dtype="float32", device="cpu")
    sharded = tdev.DeviceExpertIndex.from_host_index(port, dtype="float32",
                                                     mesh=mesh.get_mesh("cpu", 3))
    assert set(sharded.buckets) == set(single.buckets) == {128, 512}
    for bsize, b in sharded.buckets.items():
        one = single.buckets[bsize]
        g = tdev._stream_group_target(bsize, D, 4)
        assert b["epd"] % g == 0 and 3 * b["epd"] >= len(b["experts"])
        (one_shard,) = one["shards"]
        assert one["epd"] == len(one["experts"])  # one device pads nothing
        for key in ("vecs", "run_id", "run_doc", "start_pos"):
            whole = torch.cat([s[key] for s in b["shards"]])
            n = one_shard[key].shape[0]
            np.testing.assert_array_equal(whole[:n].numpy(), one_shard[key].numpy(),
                                          err_msg=key)
            assert not whole[n:].numpy().any() if key != "run_doc" else (whole[n:] == -1).all()
        np.testing.assert_array_equal(b["experts"], one["experts"])
    np.testing.assert_array_equal(sharded._route_slot, single._route_slot)
    np.testing.assert_array_equal(sharded._route_bsize, single._route_bsize)
    nt, NT = sharded._tiles()
    assert [c.shape for c in sharded.cls] == [(NT // 3, CLS_DIM)] * 3
    whole = torch.cat(sharded.cls)
    assert [c.shape for c in single.cls] == [(single._tiles()[1], CLS_DIM)]
    np.testing.assert_array_equal(whole.numpy(), single.cls[0][: whole.shape[0]].numpy())
    assert not whole[NUM_DOCS:].any()


def test_get_mesh_lists_the_devices(monkeypatch):
    assert mesh.get_mesh("cpu", 3) == [torch.device("cpu")] * 3
    assert mesh.get_mesh("cpu") == [torch.device("cpu")]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert mesh.get_mesh("cuda:0") == [torch.device("cuda", i) for i in range(4)]
    assert mesh.get_mesh("cuda:0", 2) == [torch.device("cuda", 0), torch.device("cuda", 1)]
    # a one-device mesh is the single-device index
    index = tdev.DeviceExpertIndex(10, device="cpu", mesh=mesh.get_mesh("cpu"))
    assert index.devices == [torch.device("cpu")] and index.ndev == 1


# --------------------------------------------------------------------- #
# the CLI and the served tower

MULTIVEC = ["task.model.vocab_size=32", "task.transform.max_seq_len=12", "task.type=multivec",
            "task.variant=citadel", "task.tok_projection_dim=8", "task.cls_projection_dim=8",
            "task.add_cls=true", "task.query_topk=1", "task.context_topk=2"]
QUESTIONS = ["what a book", "who b city", "c", "what book of d and e"]


def _trec(path):
    out = {}
    for line in open(path):
        qid, _q0, doc, _rank, score, _tag = line.split()
        out.setdefault(qid, []).append((doc, float(score)))
    return out


@pytest.fixture(scope="module")
def cli_setup(tmp_path_factory, tiny_bert_dir):
    """One Flax init exported for each package, the shards the JAX CLI
    writes from it, and the JAX CLI's expert-parallel mesh(8) TREC run."""
    from dpr_scale_tpu.cli import citadel_retrieval as jax_citadel
    from dpr_scale_tpu.cli import generate_multivec_embeddings as jax_multivec
    from dpr_scale_tpu.cli.common import build_model_config
    from dpr_scale_tpu.config import load_config as jax_load_config
    from dpr_scale_tpu.models.multivec import MultiVecEncoder as JaxMultiVec
    from dpr_scale_tpu.train.checkpoint import save_params as jax_save_params
    from dpr_scale_tpu_torch.models.convert import from_jax_params
    from dpr_scale_tpu_torch.train.checkpoint import save_params

    d = tmp_path_factory.mktemp("expert_parallel_cli")
    words = list("abcdefghij")
    with open(d / "passages.tsv", "w") as f:
        f.write("id\ttext\ttitle\n")
        f.writelines(f"p{i}\t{words[i % 10]} {words[i // 10]} book {words[(3 * i) % 10]}"
                     f"\tcity {i % 3}\n" for i in range(40))  # no two passages alike
    with open(d / "queries.tsv", "w") as f:
        f.writelines(f"q{i}\t{q}\n" for i, q in enumerate(QUESTIONS))
    base = ["--config", os.path.join(CONF, "tiny_smoke.yaml"),
            f"task.transform.model_path={tiny_bert_dir}", *MULTIVEC,
            f"datamodule.passages_path={d}/passages.tsv", f"datamodule.test_path={d}/queries.tsv",
            "datamodule.trec_format=true", "datamodule.encode_batch_size=4"]
    jcfg = build_model_config(jax_load_config(base[1], base[2:]))
    model = JaxMultiVec(jcfg, variant="citadel", tok_projection_dim=8, cls_projection_dim=8)
    ones = jnp.ones((1, 12), jnp.int32)
    params = jax.device_get(
        model.init(jax.random.PRNGKey(4), ones, ones, topk=2, add_cls=True)["params"])
    jax_save_params(str(d / "init_jax"), params)
    save_params(str(d / "init_port"), from_jax_params(params))
    index = [f"task.ctx_embeddings_dir={d}/index", "task.topk=10",
             "task.device_index_dtype=float32"]
    jax_multivec.main(base + index[:1] + [f"task.checkpoint_path={d}/init_jax"])
    jax_citadel.main(base + index + [f"task.checkpoint_path={d}/init_jax",
                                     "task.device_index=true", "task.expert_parallel=true",
                                     f"task.output_trec_path={d}/jax_ep.trec"])
    port = base[:2] + ["--device", "cpu"] + base[2:] + index + [
        f"task.checkpoint_path={d}/init_port", "task.device_index=true"]
    return d, port


@pytest.mark.parametrize("ndev", [8, 3])
def test_cli_expert_parallel_writes_the_same_trec(cli_setup, ndev, monkeypatch):
    """``task.expert_parallel=true`` over ``ndev`` shards of the CPU: the
    same TREC file as the single-device run (scores within 1e-5 relative)
    and as the JAX CLI's mesh(8) run (1e-4)."""
    from dpr_scale_tpu_torch.cli import citadel_retrieval

    d, port = cli_setup
    citadel_retrieval.main(port + [f"task.output_trec_path={d}/one_{ndev}.trec"])
    monkeypatch.setattr(mesh, "get_mesh", lambda device, n=None: [torch.device(device)] * ndev)
    citadel_retrieval.main(port + ["task.expert_parallel=true",
                                   f"task.output_trec_path={d}/ep_{ndev}.trec"])
    one, ep, jax_ep = (_trec(d / name) for name in (f"one_{ndev}.trec", f"ep_{ndev}.trec",
                                                     "jax_ep.trec"))
    assert one.keys() == ep.keys() == jax_ep.keys() and len(one) == len(QUESTIONS)
    for qid in one:
        assert [doc for doc, _s in ep[qid]] == [doc for doc, _s in one[qid]], qid
        np.testing.assert_allclose([s for _d, s in ep[qid]], [s for _d, s in one[qid]],
                                   rtol=1e-5, atol=1e-6)
        assert [doc for doc, _s in ep[qid]] == [doc for doc, _s in jax_ep[qid]], qid
        np.testing.assert_allclose([s for _d, s in ep[qid]], [s for _d, s in jax_ep[qid]],
                                   rtol=0, atol=1e-4)


def test_search_citadel_answers_alike_with_expert_parallel(cli_setup, monkeypatch):
    """``/search_citadel`` of a tower built with
    ``serve_citadel.expert_parallel=true`` (3 shards of the CPU) answers as
    the single-device tower's."""
    from dpr_scale_tpu_torch.cli import serve
    from dpr_scale_tpu_torch.config import load_config
    from dpr_scale_tpu_torch.retrieve.server import make_server

    d, port = cli_setup
    over = [a for a in port[4:] if a.startswith(("task.transform", "task.model", "task.type",
                                                 "task.variant", "task.tok", "task.cls",
                                                 "task.add_cls", "task.query", "task.context",
                                                 "task.checkpoint", "datamodule.passages"))]
    over += [f"serve_citadel.ctx_embeddings_dir={d}/index", "serve_citadel.add_cls=true",
             "serve_citadel.k=6", "serve_citadel.device_index_dtype=float32"]
    cfg = os.path.join(CONF, "tiny_smoke.yaml")
    plain = serve.build_citadel_retriever(load_config(cfg, over), device="cpu")
    monkeypatch.setattr(mesh, "get_mesh", lambda device, n=None: [torch.device("cpu")] * 3)
    sharded = serve.build_citadel_retriever(
        load_config(cfg, over + ["serve_citadel.expert_parallel=true"]), device="cpu")
    assert sharded.index.ndev == 3 and plain.index.ndev == 1
    answers = []
    for retriever in (plain, sharded):
        server = make_server(None, "127.0.0.1", 0, citadel_retriever=retriever)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            req = urllib.request.Request(
                f"http://127.0.0.1:{server.server_address[1]}/search_citadel",
                data=json.dumps({"questions": QUESTIONS, "k": 6}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as resp:
                answers.append(json.loads(resp.read())["results"])
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=10)
    want, got = answers
    assert len(got) == len(QUESTIONS) and all(len(r) == 6 for r in got)
    for g, w in zip(got, want):
        assert [c["id"] for c in g] == [c["id"] for c in w]
        np.testing.assert_allclose([c["score"] for c in g], [c["score"] for c in w],
                                   rtol=1e-5, atol=1e-6)


def test_chip_smoke_phase_23a_runs_on_cpu(capsys):
    """chip_smoke.py phase 23 (a) at a tiny size on 3 shards of the CPU
    (70,000 docs, over sorted_combine_min_docs: the search without CLS takes
    the sorted combine): every sharded search equals the single-device one;
    no kernel launches on CPU tensors, so the run that needs one is named."""
    import chip_smoke

    runs = chip_smoke._RestRuns(chip_smoke._ep_counters, "expert-parallel")
    chip_smoke._ep_search(torch.device("cpu"), "", runs, None, shards=3, n_docs=70_000,
                          plan=((128, 40), (512, 16), (2048, 4)), batch=6, qtokens=8, dim=8,
                          cls_dim=8, reps=1)
    out = capsys.readouterr().out
    for tag in ("with CLS", "without CLS"):
        assert f"expert-parallel (a) search {tag} (B=6, 8 tokens, k=100): 3 shards" in out
        assert "0 of 6 queries disagree" in out
    assert "the largest shard's accumulator (6, 24576) fp32" in out
    assert runs.missing == ["a 3-shard searches: gather_score_serial"]
