"""The frozen operation and byte counts against hand counts at one small
shape."""
import pytest

from perfbench.harness import bench, work
from perfbench.harness.recorder import Recorder, Step, WallClock, WindowClosed

PK = {"bf16_flops_per_s": 1e12, "hbm_bytes_per_s": 1e9}
CFG = {"n_layers": 2, "d_model": 8, "n_heads": 4, "n_kv_heads": 2,
       "head_dim": 2, "d_ff": 16, "vocab_size": 32, "glu": True,
       "attn": {"layer_pattern": ["local", "global"], "sliding_window": 3},
       "lora": {"rank": 2, "target_modules": ["q", "v", "down"]}}


def test_pairs_causal_and_windowed():
    assert work.pairs(4, None) == 1 + 2 + 3 + 4
    assert work.pairs(5, 3) == 1 + 2 + 3 + 3 + 3
    assert work.pairs(3, 8) == 6


def test_flash_prefill_bound_by_hand():
    rows = [work.Row(tenant=0, tokens=5, start=0),
            work.Row(tenant=1, tokens=2, start=0)]
    out = work.Bound()
    work.flash_prefill_bound(CFG, rows, PK, out)
    # layer 0 (window 3): pairs 1+2+3+3+3 = 12 and 1+2 = 3; layer 1: 15, 3
    per_pair = 4 * 4 * 2          # 4 heads x head dim 2 x (q.k + p.v)
    assert out.flops == per_pair * (12 + 3) + per_pair * (15 + 3)
    # q and o: 4 heads, k and v: 2 heads, 2 dims, 2 bytes, 7 tokens a layer
    assert out.bytes == 2 * 7 * (2 * 4 + 2 * 2) * 2 * 2
    assert out.seconds == pytest.approx(
        max(per_pair * 15 / 1e12, 336 / 1e9)
        + max(per_pair * 18 / 1e12, 336 / 1e9))


def test_sgmv_bound_by_hand():
    rows = [work.Row(0, 3, 0), work.Row(0, 1, 0), work.Row(5, 2, 0)]
    out = work.Bound()
    work.sgmv_bound(CFG, rows, PK, out)
    t, n, r = 6, 2, 2
    dims = [(8, 8), (8, 4), (16, 8)]          # q, v, down
    flops = sum(2 * t * r * (a + b) for a, b in dims)
    nbytes = sum(t * (a + b) * 2 + n * r * (a + b) * 4 for a, b in dims)
    assert out.flops == 2 * flops             # two layers
    assert out.bytes == 2 * nbytes


def test_model_flops_by_hand():
    row = work.Row(tenant=0, tokens=1, start=4)   # a decode at position 4
    lin = 8 * (8 + 2 * 4) + 8 * 8 + 3 * 8 * 16
    lora = 2 * 2 * ((8 + 8) + (8 + 4) + (16 + 8))
    attn = 4 * 4 * 2 * (3 + 5)                 # 3 keys windowed, 5 global
    assert work.model_flops(CFG, [row]) == (2 * (2 * lin + lora) + attn
                                           + 2 * 8 * 32)


def test_step_rows_follow_each_request():
    class R:
        def __init__(self, plen, aid):
            self.prompt_len, self.adapter_id = plen, aid
    reqs = {1: R(10, 3), 2: R(7, 4)}
    steps = [Step("prefill", 0, 1, (1, 2)), Step("decode", 1, 2, (1, 2)),
             Step("decode", 2, 3, (1,))]
    rows = [r for _, r in work.step_rows(steps, reqs)]
    assert [(x.tokens, x.start) for x in rows[0]] == [(10, 0), (7, 0)]
    assert [(x.tokens, x.start) for x in rows[1]] == [(1, 10), (1, 7)]
    assert [(x.tokens, x.start, x.tenant) for x in rows[2]] == [(1, 11, 3)]


def _recorded(steps, seconds):
    """A recorder fed ``steps`` (kind, t0, t1, requests) until its budget
    closes the window."""
    clock = WallClock()
    rec = Recorder(clock, seconds, lambda: (0, 0))
    with pytest.raises(WindowClosed):
        for kind, t0, t1, rids in steps:
            clock.readings[:] = [t0, t1]
            rec.compute(0.0, t1 - t0, (kind, 8, len(rids)), rids)
    return rec


# the backlog's fill, then loop iterations of a prefill and a decode step
STEPS = [("prefill", 0.0, 2.0, (0, 1)), ("decode", 2.0, 2.3, (0, 1)),
         ("prefill", 2.5, 2.9, (2,)), ("decode", 2.9, 3.2, (1, 2)),
         ("prefill", 3.5, 3.9, (3,)), ("decode", 3.9, 4.2, (2, 3)),
         ("prefill", 4.5, 4.9, (4,)), ("decode", 4.9, 5.2, (3, 4)),
         ("prefill", 5.5, 5.9, (5,))]


@pytest.mark.parametrize("seconds,end", [(1.85, 3.5), (2.2, 4.5),
                                         (2.6, 4.5), (2.8, 4.5)])
def test_the_window_holds_whole_loop_iterations(seconds, end):
    """It opens at the second prefill step and ends at the start of the
    last prefill step inside the budget, wherever the budget runs out."""
    rec = _recorded(STEPS, seconds)
    assert rec.start == 2.5
    assert bench.window_end(rec, rec.start) == end
    firsts = rec.first_tokens(rec.start, end)
    assert sorted(firsts) == ([2, 3] if end == 4.5 else [2])
    assert 0 not in firsts and 1 not in firsts     # the fill's requests
    gaps = {rid: [round(b - a, 6) for a, b in zip(ts, ts[1:]) if b > 2.5]
            for rid, ts in rec.tokens_in(rec.start, end).items()}
    if end == 4.5:
        assert gaps == {1: [0.9], 2: [0.3, 1.0], 3: [0.3]}
    else:
        assert gaps == {1: [0.9], 2: [0.3]}
