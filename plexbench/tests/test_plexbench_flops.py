"""The analytic FLOP and byte functions against the kernel table's rows
(PERF.md, section 6) and the dense model's counts."""
import pytest

from plexbench import flops


def test_k1_row_qwen2_prefill():
    # K1, bf16, B=16 S=T=128 H=14 K=2 D=64 causal: 0.473 GFLOP, 8.39 MB,
    # bound 0.00250 ms
    f, b = flops.k1(16, 128, 128, 14, 2, 64)
    assert f == 4 * 16 * 14 * 64 * (128 * 129 // 2)
    assert f / 1e9 == pytest.approx(0.473, abs=5e-4)
    assert b == 8_388_608
    assert flops.bound_s(f, b) * 1e3 == pytest.approx(0.00250, abs=5e-6)


def test_k1_row_gemma2_long_global():
    # K1, B=1 S=T=4352 H=32 K=16 D=128 causal: 155.2 GFLOP, 107 MB,
    # bound 0.157 ms (compute-bound)
    f, b = flops.k1(1, 4352, 4352, 32, 16, 128)
    assert f / 1e9 == pytest.approx(155.2, abs=0.05)
    assert b / 1e6 == pytest.approx(107.0, abs=0.5)
    assert flops.bound_s(f, b) * 1e3 == pytest.approx(0.157, abs=5e-4)


@pytest.mark.parametrize("b,h,kh,d,pos,mflop,mbytes,bound_ms", [
    (16, 14, 2, 64, 191, 11.0, 1.63, 0.000487),      # qwen2 serving
    (16, 14, 2, 64, 4095, 234.9, 33.6, 0.01003),     # long cache
    (1, 14, 2, 64, 8191, 29.4, 4.20, 0.00125),       # straggler
])
def test_k2_rows(b, h, kh, d, pos, mflop, mbytes, bound_ms):
    f, nb = flops.k2(b, h, kh, d, pos)
    assert f / 1e6 == pytest.approx(mflop, rel=2e-3)
    assert nb / 1e6 == pytest.approx(mbytes, rel=2e-3)
    assert flops.bound_s(f, nb) * 1e3 == pytest.approx(bound_ms, rel=3e-3)


def test_causal_pairs_with_a_query_offset():
    assert flops.causal_pairs(4, 4) == 10
    # 2 queries at positions 3 and 4 of 5 keys: 4 + 5
    assert flops.causal_pairs(2, 5) == 9


def _cfg():
    return {"hidden_size": 8, "intermediate_size": 16, "vocab_size": 32,
            "num_attention_heads": 2, "num_key_value_heads": 1,
            "head_dim": 4, "num_hidden_layers": 3}


def test_matmul_params_count_each_projection_and_the_head():
    per = 8 * (2 + 2) * 4 + 2 * 4 * 8 + 3 * 8 * 16
    assert flops.matmul_params(_cfg()) == 3 * per + 8 * 32


def test_update_is_three_forwards_and_generate_adds_each_token():
    cfg = _cfg()
    fwd = flops.forward_flops(cfg, 2, 5)
    assert flops.update_flops(cfg, 2, 5) == 3 * fwd
    n = flops.matmul_params(cfg)
    attn = 4 * 2 * 4 * 3
    want = fwd + 2 * (2 * n + attn * 6) + 2 * (2 * n + attn * 7)
    assert flops.generate_flops(cfg, 2, 5, 2) == want


def test_qwen2_counts():
    import json
    from pathlib import Path
    from plexbench import weights
    cfg = json.loads((Path(__file__).parents[1] / "configs"
                      / "qwen2-0.5b.json").read_text())
    # Qwen2-0.5B's published count: 494,032,768 parameters
    assert weights.param_count(cfg) == 494_032_768
    biases, norms = 24 * (896 + 2 * 128), 24 * 2 * 896 + 896
    assert flops.matmul_params(cfg) == 494_032_768 - biases - norms
