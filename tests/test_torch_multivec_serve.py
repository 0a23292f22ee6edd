"""The port's CITADEL serving tower (``CitadelRetriever``, ``/search_citadel``,
``cli.serve``'s ``serve_citadel``) against the JAX package's, on the CPU.

One Flax ``MultiVecEncoder`` init serves both sides (the port's through
``from_jax_params``), over expert shards that the port's
``generate_multivec_embeddings`` wrote from the same weights and both
packages load. Each query's ranked scores within 1e-4 of JAX's, with the
host index and with the device index in fp32 (the CITADEL CLI tests'
tolerance); the passages repeat, so tied documents may swap places: a
document in one list only must tie with the other list's last score.
"""
import json
import os
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dpr_scale_tpu_torch.cli import generate_embeddings, generate_multivec_embeddings, serve
from dpr_scale_tpu_torch.config import load_config
from dpr_scale_tpu_torch.models.convert import from_jax_params
from dpr_scale_tpu_torch.retrieve.server import CitadelRetriever, make_server
from dpr_scale_tpu_torch.train.checkpoint import save_params

CONF = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "conf")
TOL = 1e-4
QUESTIONS = ["what a book", "who b city", "c", "what book of d and e"]
MULTIVEC = ["task.model.vocab_size=32", "task.transform.max_seq_len=12", "task.type=multivec",
            "task.variant=citadel", "task.tok_projection_dim=8", "task.cls_projection_dim=8",
            "task.add_cls=true", "task.query_topk=1", "task.context_topk=2"]


@pytest.fixture(scope="module")
def served(tmp_path_factory, tiny_bert_dir):
    """Flax weights, the port's export of them, passages and the shards."""
    from dpr_scale_tpu.cli.common import build_model_config
    from dpr_scale_tpu.config import load_config as jax_load_config
    from dpr_scale_tpu.models.multivec import MultiVecEncoder as JaxMultiVec

    d = tmp_path_factory.mktemp("multivec_serve")
    words = list("abcdefghij")
    with open(d / "passages.tsv", "w") as f:
        f.write("id\ttext\ttitle\n")
        f.writelines(f"p{i}\t{words[i % 10]} {words[(3 * i) % 10]} book\tcity {i % 3}\n"
                     for i in range(14))
    base = [f"task.transform.model_path={tiny_bert_dir}", *MULTIVEC,
            f"datamodule.passages_path={d}/passages.tsv", "datamodule.encode_batch_size=4"]
    jcfg = build_model_config(jax_load_config(os.path.join(CONF, "tiny_smoke.yaml"), base))
    model = JaxMultiVec(jcfg, variant="citadel", tok_projection_dim=8, cls_projection_dim=8)
    ones = jnp.ones((1, 12), jnp.int32)
    params = jax.device_get(
        model.init(jax.random.PRNGKey(3), ones, ones, topk=2, add_cls=True)["params"])
    save_params(str(d / "export"), from_jax_params(params))
    base.append(f"task.checkpoint_path={d}/export")
    generate_multivec_embeddings.main(["--config", os.path.join(CONF, "tiny_smoke.yaml"),
                                       "--device", "cpu", *base,
                                       f"task.ctx_embeddings_dir={d}/index"])
    return d, base, model, params


def _jax_retriever(d, model, params, tiny_bert_dir):
    from dpr_scale_tpu.data.datasets import CSVDataset
    from dpr_scale_tpu.data.tokenize import HFTokenizer
    from dpr_scale_tpu.index.inverted import InvertedExpertIndex
    from dpr_scale_tpu.retrieve.server import CitadelRetriever as JaxCitadelRetriever

    passages = CSVDataset(str(d / "passages.tsv"))
    index = InvertedExpertIndex.load(str(d / "index"), num_docs=len(passages))
    return JaxCitadelRetriever(model, params, HFTokenizer(tiny_bert_dir, max_seq_len=12), index,
                               passages, topk_route=1, add_cls=True, default_k=5)


def _port_retriever(d, base, device_index):
    over = [*base, f"serve_citadel.ctx_embeddings_dir={d}/index", "serve_citadel.query_topk=1",
            "serve_citadel.add_cls=true", "serve_citadel.k=5",
            f"serve_citadel.device_index={str(device_index).lower()}",
            "serve_citadel.device_index_dtype=float32"]
    return serve.build_citadel_retriever(
        load_config(os.path.join(CONF, "tiny_smoke.yaml"), over), device="cpu")


def _assert_same_results(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        gs, ws = [c["score"] for c in g], [c["score"] for c in w]
        np.testing.assert_allclose(gs, ws, rtol=0, atol=TOL)
        gd, wd = {c["id"]: c["score"] for c in g}, {c["id"]: c["score"] for c in w}
        for doc in gd.keys() & wd.keys():
            assert abs(gd[doc] - wd[doc]) <= TOL, doc
        for doc in gd.keys() ^ wd.keys():
            assert gd.get(doc, wd.get(doc)) <= min(gs[-1], ws[-1]) + TOL, doc


@pytest.mark.parametrize("device_index", [False, True], ids=["host_index", "device_index"])
def test_citadel_retriever_matches_jax(served, tiny_bert_dir, device_index):
    d, base, model, params = served
    want = _jax_retriever(d, model, params, tiny_bert_dir)
    got = _port_retriever(d, base, device_index)
    assert isinstance(got, CitadelRetriever) and got.num_rows == want.num_rows == 14
    for k in (None, 3, 9):
        _assert_same_results(got.search(QUESTIONS, k=k), want.search(QUESTIONS, k=k))


def test_search_citadel_over_http_matches_jax(served, tiny_bert_dir):
    """``/search_citadel`` alone: /healthz lists only that tower, /search is
    404, and one request of several questions answers as JAX's retriever."""
    d, base, model, params = served
    want = _jax_retriever(d, model, params, tiny_bert_dir).search(QUESTIONS, k=4)
    server = make_server(None, "127.0.0.1", 0, citadel_retriever=_port_retriever(d, base, True))
    url = f"http://127.0.0.1:{server.server_address[1]}"
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        with urllib.request.urlopen(url + "/healthz", timeout=60) as resp:
            health = json.loads(resp.read())
        assert health == {"status": "ok", "corpus_rows": 14, "towers": ["/search_citadel"]}
        post = lambda path: urllib.request.urlopen(urllib.request.Request(
            url + path, data=json.dumps({"questions": QUESTIONS, "k": 4}).encode(),
            headers={"Content-Type": "application/json"}), timeout=60)
        with post("/search_citadel") as resp:
            got = json.loads(resp.read())["results"]
        with pytest.raises(urllib.error.HTTPError, match="404"):
            post("/search")
    finally:
        server.shutdown()
        thread.join(timeout=10)
    _assert_same_results(got, want)
    with pytest.raises(ValueError, match="at least one retriever"):
        make_server(None, "127.0.0.1", 0)


@pytest.mark.parametrize("towers", [("citadel",), ("dense",), ("dense", "citadel")])
def test_serve_main_builds_the_configured_towers(served, towers, monkeypatch):
    """As JAX's ``cli.serve.main``: the dense tower only with
    ``task.ctx_embeddings_dir``, the CITADEL tower only with the
    ``serve_citadel`` group."""
    d, base, _model, _params = served
    argv = ["--config", os.path.join(CONF, "tiny_smoke.yaml"), "--device", "cpu", *base,
            "serve.host=127.0.0.1", "serve.port=0"]
    if "dense" in towers:
        dense = [a for a in argv if not a.startswith("task.type")] + [
            f"task.ctx_embeddings_dir={d}/dense", "task.checkpoint_path="]
        if not os.path.exists(d / "dense"):
            generate_embeddings.main(dense)
        argv = dense + [a for a in argv if a.startswith("task.type")]
    if "citadel" in towers:
        argv.append(f"serve_citadel.ctx_embeddings_dir={d}/index")
    seen = {}

    class Stop(Exception):
        pass

    def capture(retriever, host, port, citadel_retriever=None):
        seen.update(dense=retriever, citadel=citadel_retriever)
        server = make_server(retriever, host, port, citadel_retriever)
        server.server_close()
        raise Stop

    monkeypatch.setattr(serve, "make_server", capture)
    with pytest.raises(Stop):
        serve.main(argv)
    assert (seen["dense"] is not None) == ("dense" in towers)
    assert isinstance(seen["citadel"], CitadelRetriever) == ("citadel" in towers)
