"""Port serving slice (encoder CLI, index, Retriever, HTTP) against the JAX package."""
import dataclasses
import json
import os
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from dpr_scale_tpu.data.datasets import CSVDataset
from dpr_scale_tpu.data.tokenize import HFTokenizer
from dpr_scale_tpu.encode.embeddings import CorpusEncoder as JaxCorpusEncoder
from dpr_scale_tpu.encode.embeddings import load_embedding_shards as jax_load_shards
from dpr_scale_tpu.index import MipsIndex as JaxMipsIndex
from dpr_scale_tpu.models import BiEncoder as JaxBiEncoder
from dpr_scale_tpu.models import TransformerConfig as JaxConfig
from dpr_scale_tpu.parallel import get_mesh
from dpr_scale_tpu.retrieve.server import Retriever as JaxRetriever
from dpr_scale_tpu_torch.cli import generate_embeddings, serve
from dpr_scale_tpu_torch.encode.embeddings import CorpusEncoder, load_embedding_shards
from dpr_scale_tpu_torch.index.mips import MipsIndex
from dpr_scale_tpu_torch.models.convert import from_jax_params
from dpr_scale_tpu_torch.models.encoder import BiEncoder
from dpr_scale_tpu_torch.models.transformer import TransformerConfig
from dpr_scale_tpu_torch.retrieve.server import Retriever, make_server

CONF = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "conf")
WORDS = ["passage", "text", "title", "query", "who", "what", "city"] + [str(i) for i in range(30)]
QUESTIONS = ["who text 3", "what city 17", "passage 5 title 12", "query"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_serve")
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + WORDS
    (d / "vocab.txt").write_text("\n".join(vocab) + "\n")
    from transformers import BertTokenizerFast

    BertTokenizerFast(vocab_file=str(d / "vocab.txt")).save_pretrained(str(d))
    rng = np.random.default_rng(0)
    passages = d / "passages.tsv"
    with open(passages, "w") as f:
        f.write("id\ttext\ttitle\n")
        for i in range(37):
            words = " ".join(rng.choice(WORDS, size=6))
            f.write(f"d{i}\tpassage {words}\ttitle {i % 30}\n")
    return d, len(vocab)


def _write_config(d, vocab_size, embs, method="fused"):
    cfg = {
        "task": {
            "model": {"arch": "tiny", "dtype": "float32", "vocab_size": vocab_size,
                      "fused_attention": True},
            "transform": {"model_path": str(d), "max_seq_len": 12},
            "shared_model": True,
            "ctx_embeddings_dir": str(embs),
        },
        "datamodule": {"passages_path": str(d / "passages.tsv"), "encode_batch_size": 8},
        "serve": {"method": method, "k": 3} if method else {"k": 3},
    }
    path = d / f"tiny_torch_{method}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def test_retriever_matches_jax_retriever(corpus):
    """Same weights through the bridge, same corpus embeddings: the same ids
    in order, scores within 1e-4 (fp32 encoders, summation-order noise)."""
    d, V = corpus
    tok = HFTokenizer(str(d), max_seq_len=12)
    jcfg = dataclasses.replace(JaxConfig.tiny(vocab_size=V), dtype=jnp.float32,
                               fused_attention=True)
    jmodel = JaxBiEncoder(jcfg, shared=True)
    ids = jnp.ones((2, 12), jnp.int32)
    params = jmodel.init(jax.random.PRNGKey(3), ids, ids, ids, ids)["params"]
    rng = np.random.default_rng(3)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + rng.normal(0, 0.05, p.shape).astype(np.float32), params
    )
    passages = CSVDataset(str(d / "passages.tsv"), cache_index=False)
    cids, cmask = tok([passages[i]["text"] for i in range(len(passages))])
    mesh = get_mesh(1)
    emb = np.asarray(JaxCorpusEncoder(jmodel, params, mesh)._encode(params, cids, cmask))
    jindex = JaxMipsIndex(mesh, dtype=jnp.float32)
    jindex.add(emb)
    jret = JaxRetriever(JaxCorpusEncoder(jmodel, params, mesh, use_query_tower=True),
                        tok, jindex, passages, default_k=5)

    tcfg = TransformerConfig(**{
        **{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(TransformerConfig)
           if f.name != "dtype"},
        "dtype": torch.float32,
    })
    model = BiEncoder(tcfg, shared=True)
    model.load_state_dict(from_jax_params(params))
    index = MipsIndex("cpu", dtype=torch.float32)
    index.add(emb)
    tret = Retriever(CorpusEncoder(model, "cpu", use_query_tower=True), tok, index,
                     passages, default_k=5)
    for k in (None, 7):
        want = jret.search(QUESTIONS, k=k)
        got = tret.search(QUESTIONS, k=k)
        assert [[c["id"] for c in r] for r in got] == [[c["id"] for c in r] for r in want]
        np.testing.assert_allclose(
            [[c["score"] for c in r] for r in got],
            [[c["score"] for c in r] for r in want], atol=1e-4, rtol=0,
        )


def test_generate_embeddings_cli_then_http_serve(corpus, tmp_path):
    d, V = corpus
    embs = tmp_path / "embs"
    cfg_path = _write_config(d, V, embs)
    path = generate_embeddings.main(["--config", cfg_path, "--device", "cpu"])
    assert path.endswith("reps_0000.pkl")

    # the JAX loader reads the port's shard back equal
    (name, jax_emb), = jax_load_shards(str(embs))
    (_, port_emb), = load_embedding_shards(str(embs))
    assert name == "reps_0000.pkl" and jax_emb.dtype == np.float32
    assert jax_emb.shape == (37, 16)
    np.testing.assert_array_equal(jax_emb, port_emb)
    manifest = json.loads((embs / "manifest.json").read_text())
    assert manifest["0"]["rows"] == 37 and manifest["0"]["corpus_offset"] == 0

    from dpr_scale_tpu_torch.config import load_config

    cfg = load_config(cfg_path)
    retriever = serve.build_retriever(cfg, device="cpu")
    server = make_server(retriever, "127.0.0.1", 0)
    url = f"http://127.0.0.1:{server.server_address[1]}"
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        with urllib.request.urlopen(url + "/healthz", timeout=60) as resp:
            health = json.loads(resp.read())
        assert health == {"status": "ok", "corpus_rows": 37, "towers": ["/search"]}
        req = urllib.request.Request(
            url + "/search", data=json.dumps({"questions": QUESTIONS, "k": 4}).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=60) as resp:
            results = json.loads(resp.read())["results"]
    finally:
        server.shutdown()
        thread.join(timeout=30)
    assert not thread.is_alive()

    # exact top-4 of the served query embeddings over the encoded shard,
    # both cast to the index's bf16 and scored in fp32
    tok = HFTokenizer(str(d), max_seq_len=12)
    bf = lambda a: torch.as_tensor(a).bfloat16().float()
    q = bf(retriever.encoder.encode(*tok(QUESTIONS)))
    scores = (q @ bf(jax_emb).T).numpy()
    want = np.argsort(-scores, axis=1, kind="stable")[:, :4]
    assert [[c["id"] for c in r] for r in results] == [[f"d{j}" for j in row] for row in want]
    for r, s_row, w_row in zip(results, scores, want):
        np.testing.assert_allclose([c["score"] for c in r], s_row[w_row], atol=1e-5)
    # the opt-in two-stage (encode | search) pipeline serves the same results
    retriever.serialized = False
    assert retriever.search(QUESTIONS, k=4) == results


def test_checkpoint_path_is_refused(corpus, tmp_path):
    d, V = corpus
    cfg_path = _write_config(d, V, tmp_path / "embs")
    with pytest.raises(ValueError, match="orbax"):
        generate_embeddings.main(
            ["--config", cfg_path, "--device", "cpu", "task.checkpoint_path=/ckpt"]
        )


def test_serve_method_defaults_to_approx_as_in_the_jax_cli(corpus, tmp_path):
    """Without serve.method both CLIs build an "approx" index; the port
    builds and serves each of its five exact methods with the same answers,
    and the quantised ones (``serve.int8_query_planes`` read as in the JAX
    CLI) with the answers of the JAX index of that tier over the same rows
    and the served query embeddings."""
    from dpr_scale_tpu.cli import serve as jax_serve
    from dpr_scale_tpu.config import load_config as jax_load_config
    from dpr_scale_tpu_torch.config import load_config

    d, V = corpus
    embs = tmp_path / "embs"
    cfg_path = _write_config(d, V, embs, method=None)
    generate_embeddings.main(["--config", cfg_path, "--device", "cpu"])
    jcfg = jax_load_config(os.path.join(CONF, "tiny_smoke.yaml"), [
        f"task.transform.model_path={d}", f"task.model.vocab_size={V}",
        f"task.ctx_embeddings_dir={embs}", f"datamodule.passages_path={d}/passages.tsv"])
    assert "serve" not in jcfg
    assert jax_serve.build_retriever(jcfg).index.method == "approx"
    retriever = serve.build_retriever(load_config(cfg_path), device="cpu")
    assert retriever.index.method == "approx"
    want = retriever.search(QUESTIONS, k=4)
    for method in ("fused", "groupmax", "auto", "exact_sort"):
        cfg = load_config(cfg_path, [f"serve.method={method}"])
        got = serve.build_retriever(cfg, device="cpu")
        assert got.index.method == method
        assert [[c["id"] for c in r] for r in got.search(QUESTIONS, k=4)] == [
            [c["id"] for c in r] for r in want]
    tok = HFTokenizer(str(d), max_seq_len=12)
    (_, emb), = load_embedding_shards(str(embs))
    for method, planes in (("int8", 1), ("int4", 1), ("int4", 2)):
        got = serve.build_retriever(load_config(cfg_path, [
            f"serve.method={method}", f"serve.int8_query_planes={planes}"]), device="cpu")
        assert (got.index.method, got.index.int8_query_planes) == (method, planes)
        results = got.search(QUESTIONS, k=4)
        ref = JaxMipsIndex(get_mesh(1), method=method)
        ref.int8_query_planes = planes
        ref.add(emb)
        ws, wi = ref.search(got.encoder.encode(*tok(QUESTIONS)).numpy(), k=4)
        for r, w_s, w_i in zip(results, ws, wi):
            scores = [c["score"] for c in r]
            np.testing.assert_allclose(scores, w_s, rtol=1e-6)
            clear = [c["id"] for c in r if c["score"] > w_s[-1] + 1e-6 * abs(w_s[-1]) + 1e-9]
            assert clear == [f"d{j}" for j in w_i[: len(clear)]]
