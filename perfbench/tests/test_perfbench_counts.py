"""FLOP and byte counts against hand counts for both configurations."""

import math

import pytest

from perfbench import flops, spec
from perfbench.layouts import dense_decoder as layout
from perfbench.run import ROOT

MISTRAL_PARAMS = 1_140_887_552  # 4 of 32 layers, embedding and head kept
DEEPSEEK_PARAMS = 1_648_398_336  # 4 of 30 layers


def cell(name):
    return spec.load_cell(name, ROOT)


def n_params(config):
    return sum(math.prod(shape) for _, shape, _ in layout.leaves(layout.dims(config)))


def counts(name, peaks=(989e12, 3.35e12)):
    c = cell(name)
    return spec.kind_module(c.config["kind"]).counts(c.config, c.traffic, peaks)


@pytest.mark.parametrize("name, params", [("mistral7b-train-16k", MISTRAL_PARAMS),
                                          ("deepseek7b-train-4k", DEEPSEEK_PARAMS)])
def test_parameters(name, params):
    assert n_params(cell(name).config) == params


# By hand: 6 x (projection weights with lm_head, no embedding) x tokens, plus
# 4 layers of causal attention, 3 x 4 D H B L(L+1)/2.
# Mistral: 4 x (2 x 4096^2 + 2 x 4096 x 1024 + 3 x 4096 x 14336) + 32768 x 4096
# DeepSeek: 4 x (4 x 4096^2 + 3 x 4096 x 11008) + 102400 x 4096
MISTRAL_DENSE = 4 * (2 * 4096 ** 2 + 2 * 4096 * 1024 + 3 * 4096 * 14336) + 32768 * 4096
DEEPSEEK_DENSE = 4 * (4 * 4096 ** 2 + 3 * 4096 * 11008) + 102400 * 4096


@pytest.mark.parametrize("name, dense, B, L, approx", [
    ("mistral7b-train-16k", MISTRAL_DENSE, 2, 16384, 2.507e14),
    ("mistral7b-train-4k", MISTRAL_DENSE, 8, 4096, 2.111e14),
    ("deepseek7b-train-4k", DEEPSEEK_DENSE, 4, 4096, 1.274e14),
])
def test_step_flops(name, dense, B, L, approx):
    want = 6 * dense * B * L + 4 * 3 * 4 * 128 * 32 * B * L * (L + 1) // 2
    got = counts(name)["step_flops"]
    assert got == want
    assert got == pytest.approx(approx, rel=1e-3)


def test_flash_bounds_at_16k():
    # B 2, 32 heads, 8 KV heads, D 128, L 16384, bf16: every role bound by its products
    pairs = 16384 * 16385 // 2 * 32 * 2
    b = counts("mistral7b-train-16k")["kernel_bound_ms"]
    assert b["flash_fwd"] == pytest.approx(4 * 128 * pairs / 989e12 * 1e3)
    assert b["flash_dkdv"] == pytest.approx(8 * 128 * pairs / 989e12 * 1e3)
    assert b["flash_dq"] == pytest.approx(6 * 128 * pairs / 989e12 * 1e3)
    assert b["flash_fwd"] == pytest.approx(4.4473, rel=1e-4)


def test_attention_bytes_count_kv_heads():
    # q and o at 32 heads, k and v at 8, lse float32 at 32 heads
    q = 1 * 32 * 4096 * 128 * 2
    kv = 1 * 8 * 4096 * 128 * 2
    rows = 32 * 4096 * 4
    nbytes, fl = flops.attention_kernel_work("flash_fwd", 1, 32, 8, 4096, 128, 2)
    assert nbytes == 2 * q + 2 * kv + rows
    assert fl == 4 * 128 * 32 * 4096 * 4097 // 2
    nbytes, _ = flops.attention_kernel_work("flash_dkdv", 1, 32, 8, 4096, 128, 2)
    assert nbytes == 2 * q + 4 * kv + 2 * rows
    nbytes, _ = flops.attention_kernel_work("flash_dq", 1, 32, 8, 4096, 128, 2)
    assert nbytes == 3 * q + 2 * kv + 2 * rows


def test_bound_is_the_larger_of_bytes_and_products():
    assert flops.bound_ms(3.35e12, 1.0, 989e12, 3.35e12) == pytest.approx(1e3)
    assert flops.bound_ms(1.0, 989e12, 989e12, 3.35e12) == pytest.approx(1e3)


def test_peaks_table():
    assert flops.peaks("NVIDIA H100 80GB HBM3") == (989e12, 3.35e12)
    assert flops.peaks("NVIDIA H100 PCIe") == (756e12, 2.0e12)
    assert flops.peaks("cpu") is None
    assert counts("mistral7b-train-4k", peaks=None)["kernel_bound_ms"] is None
