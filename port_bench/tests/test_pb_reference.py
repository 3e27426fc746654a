"""The plain reference against the port's plain path at tiny sizes in
f32 (the test imports both; the reference imports nothing of the port):
the same weights, the same tokens, the same numbers to rounding."""
import pytest
import torch

import pb_tiny
from port_bench import harness
from port_bench.reference import judge, model as reference
from port_bench.weights import leaf_specs, make_weights


@pytest.mark.parametrize("cell", [pb_tiny.TRAIN, pb_tiny.PREFILL])
def test_forward_logits_match_the_port(cell):
    from repro_torch.train.train_step import make_prefill_step
    a = pb_tiny.arch(cell)
    w = make_weights(a, 5, "cpu")
    model, params = harness.load_program(a, w, "cpu", train=False)
    tokens = torch.randint(0, a.vocab_size, (2, 48),
                           generator=torch.Generator().manual_seed(0))
    got = make_prefill_step(model)(params, {"tokens": tokens})
    want, rows = reference.logits(a, make_weights(a, 5, "cpu"), tokens)
    assert judge.row_errors(got, want).max() < 1e-4
    moe_layers = [i for i, (_, f) in enumerate(a.layers) if f == "moe"]
    assert sorted(rows) == moe_layers
    k = a.experts_per_tok
    for counts in rows.values():
        assert len(counts) == 2 and all(len(c) == a.experts_padded
                                        for c in counts)
        assert all(sum(c) <= 48 * k for c in counts)
        assert all(max(c) <= a.capacity(48) for c in counts)


def test_training_readings_match_the_port():
    ctx = pb_tiny.ctx(pb_tiny.TRAIN)
    drv = harness.load_driver("train")
    t = drv.Trainer(ctx, drv.make_train_step)
    try:
        prog, _ = drv.program_setup(t, ctx)
    finally:
        t.close()
    ref = drv.reference_readings(ctx)
    numbers = judge.train_numbers(prog, ref, "cpu")
    assert numbers["loss_gap"] < 1e-5
    assert numbers["grad_diff_median"] < 1e-4
    assert numbers["grad_norm_gap"] < 1e-4
    assert numbers["update_norm_gap"] < 1e-3
    assert len(ref["rows"]) == drv.SETUP_STEPS


def test_capacity_drops_the_later_slots_of_a_full_expert():
    """Every token routed to expert 0 first: each batch row keeps
    `capacity` of its slots there, in token order."""
    a = pb_tiny.arch(pb_tiny.TRAIN)
    w = make_weights(a, 3, "cpu")
    w["layers.0.ffn.router"][:, 0] += 50.0 / a.d_model ** 0.5
    ref = reference.Reference(a, w)
    x = torch.ones(2, 64, a.d_model) + 0.01 * torch.randn(
        2, 64, a.d_model, generator=torch.Generator().manual_seed(1))
    _, _, rows = ref.moe("layers.0.ffn.", x)
    cap = a.capacity(64)
    assert cap < 64
    assert [r[0] for r in rows] == [cap, cap]


def test_weights_are_the_seeds_and_views_of_one_draw():
    a = pb_tiny.arch(pb_tiny.PREFILL, "bfloat16")
    w1, w2 = make_weights(a, 9, "cpu"), make_weights(a, 9, "cpu")
    w3 = make_weights(a, 10, "cpu")
    assert all(torch.equal(w1[n], w2[n]) for n in w1)
    assert not torch.equal(w1["embed.embedding"], w3["embed.embedding"])
    assert {s.name for s in leaf_specs(a)} == set(w1)
    assert w1["layers.0.mixer.a_log"].dtype == torch.float32
    assert w1["layers.0.mixer.in_proj"].dtype == torch.bfloat16
    bases = {t.untyped_storage().data_ptr() for t in w1.values()}
    assert len(bases) == 2                      # one draw a dtype


def test_control_rounds_products_to_float8():
    x = torch.randn(64, 64, generator=torch.Generator().manual_seed(2))
    y = reference.fp8(x)
    err = ((y - x).norm() / x.norm()).item()
    assert 0.005 < err < 0.1
    assert torch.equal(reference.fp8(y), y)
