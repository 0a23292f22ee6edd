"""The encoder's position and token-type embeddings give the same gradient on
every run (ROADMAP C12).

On a card ``nn.Embedding``'s backward sums the gradients of a row that many
ids repeat in an order that varies from run to run; the encoder takes those
two tables through ``models.transformer.embed_rows``, whose weight gradient
is one product with the ids' one-hot rows. Here, on the CPU, that gradient
is held to ``nn.Embedding``'s own (the op it replaced) and the lookup to its
forward, exactly; on the card (skipped without one) two seeded CITADEL
training steps of ``conf/citadel.yaml`` give the same parameters, bit for
bit, twice:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_embedding_determinism.py
"""
import os

import pytest
import torch

from dpr_scale_tpu_torch.models import transformer as tr

import torch_threads  # noqa: F401  (one intra-op thread a worker)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("rows,table,shape", [(12, 40, (6, 12)), (1, 2, (5, 9)),
                                              (30, 30, (64, 30))])
def test_one_hot_rows_grad_equals_the_embedding_backward(rows, table, shape):
    """Ids below ``rows`` of a (table, 16) weight, every row repeated many
    times (positions of a batch, the one token type): the lookup is
    ``F.embedding``'s and its weight gradient ``nn.Embedding``'s backward,
    within fp32 rounding of the same sums in another order."""
    g = torch.Generator().manual_seed(rows + table)
    weight = torch.randn(table, 16, generator=g)
    ids = torch.randint(0, rows, shape, generator=g)
    up = torch.randn(*shape, 16, generator=g)
    w1, w2 = weight.clone().requires_grad_(), weight.clone().requires_grad_()
    got = tr._OneHotRows.apply(w1, ids, rows)
    want = torch.nn.functional.embedding(ids, w2)
    assert torch.equal(got, want)
    (got * up).sum().backward()
    (want * up).sum().backward()
    torch.testing.assert_close(w1.grad, w2.grad, rtol=1e-6, atol=1e-5)
    assert (w1.grad[rows:] == 0).all()
    torch.testing.assert_close(tr.one_hot_rows_grad(up, ids, (table, 16), rows), w2.grad,
                               rtol=1e-6, atol=1e-5)


def test_embed_rows_keeps_the_module_off_the_card():
    """Off the card (and without a gradient) the lookup is the module's
    own: the CPU training steps the tests hold against JAX are unchanged."""
    table = torch.nn.Embedding(10, 4)
    ids = torch.randint(0, 10, (3, 5))
    out = tr.embed_rows(table, ids, 10)
    assert torch.equal(out, table(ids)) and out.grad_fn.name() == table(ids).grad_fn.name()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_two_seeded_citadel_steps_are_equal_on_the_card(cuda_device):
    """conf/citadel.yaml (bert_base, L = 128, dropout on) from one seed,
    two steps on the same batches, twice: every parameter equal, bit for
    bit, and the embeddings' gradients of one state equal twice."""
    from dpr_scale_tpu_torch.tools import determinism

    config = os.path.join(ROOT, "conf", "citadel.yaml")
    first, _ms = determinism.trained_params(config, (), cuda_device, 16, 2, 0)
    second, _ms = determinism.trained_params(config, (), cuda_device, 16, 2, 0)
    differ = [n for n in first if not torch.equal(first[n], second[n])]
    assert not differ, differ
    task, L = determinism.build(config, (), cuda_device)
    state = task.init_state(0)
    batch = determinism.seeded_batch(task, 16, L, cuda_device, 1)
    (la, ga), (lb, gb) = (determinism.gradients(task, state, batch) for _ in range(2))
    assert torch.equal(la, lb) and all(torch.equal(a, b) for a, b in zip(ga, gb))
