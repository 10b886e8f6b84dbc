"""Probe: how fast does each integer dot instruction run on this card?

The port's counterpart of `scripts/tpu_probe_int4.py`, which asked whether
the TPU's MXU runs int4 dots faster than int8. The function is the same:
each call runs ``P4_ROUNDS`` rounds; a round adds ``P4_PANELS`` (rows, K)
@ (K, N) int32 products against distinct weight panels, and the round's
``(acc + r) & 0xF`` becomes the next round's x (the int4 form
sign-extends x and w to 4 bits, and its output lies in [-8, 7]). Calls are
chained ``P4_SCAN`` times, each call's output the next call's x.

Here it runs through each instruction the two-level GEMVs could be built
on (`csrc/probe_int4.cu`): dp4a (what they used first), int8
``mma.sync.m16n8k32``, int4 ``mma.sync.m16n8k64 .s4`` and bf16
``mma.sync.m16n8k16`` (exact: integer operands of at most 128 in
magnitude, sums below 2**24). Every row is an independent chain, so
``P4_COPIES`` copies of the (``P4_BM``, K) activations, distinct x drawn
from the seed, fill the card.

    python -m fastforward_tpu_torch.scripts.probe_int4

prints TOP/s per route, for the card and per SM, best of ``P4_PAIRS``
interleaved passes, and checks every route's output against the plain
version. Knobs and defaults are the TPU probe's (``P4_BM`` 192, ``P4_K`` =
``P4_N`` 512, ``P4_PANELS`` 6, ``P4_ROUNDS`` 16, ``P4_SCAN`` 2000,
``P4_PAIRS`` 3), and ``P4_COPIES`` (default: enough 64-row blocks for two
on each SM).
"""

import dataclasses
import os
import sys

import numpy as np
import torch

from fastforward_tpu_torch.kernels import _build

# instruction -> the kernel's INST (csrc/probe_int4.cu)
INSTRUCTIONS = {"dp4a": 0, "mma_s8": 1, "mma_s4": 2, "mma_bf16": 3}
# (instruction, int4 form) of each route main() times: the int8 form on
# dp4a, int8 and bf16 tensor cores; the int4 form on int4 tensor cores and,
# for the same integers, on int8 ones (sign-extended nibbles as bytes)
ROUTES = (("dp4a", False), ("mma_s8", False), ("mma_s8", True), ("mma_s4", True),
          ("mma_bf16", False))
BLOCK_ROWS = 64  # rows of x one block of the kernel owns
_BF16_EXACT = 2 ** 24


@dataclasses.dataclass(frozen=True)
class Knobs:
    bm: int = 192
    k: int = 512
    n: int = 512
    panels: int = 6
    rounds: int = 16
    scan: int = 2000
    pairs: int = 3
    copies: int = 0  # 0: enough blocks for two on each SM of the card

    @staticmethod
    def from_env(env=None) -> "Knobs":
        env = os.environ if env is None else env
        names = {"bm": "P4_BM", "k": "P4_K", "n": "P4_N", "panels": "P4_PANELS",
                 "rounds": "P4_ROUNDS", "scan": "P4_SCAN", "pairs": "P4_PAIRS",
                 "copies": "P4_COPIES"}
        return Knobs(**{f: int(env[v]) for f, v in names.items() if v in env})


def default_copies(bm: int, sms: int) -> int:
    """Copies of the (bm, K) activations that put two 64-row blocks on each
    of ``sms`` SMs."""
    blocks = -(-bm // BLOCK_ROWS)
    return -(-2 * sms // blocks)


def _sext4(v):
    return ((v & 0xF) ^ 8) - 8


def probe_reference(x, w, int4: bool, rounds: int):
    """Plain version: x (..., rows, K) int8 in [0, 15], w (panels, K, N)
    int8; ``rounds`` rounds of the probe's function (the products exact in
    float64), its last x as int8."""
    xi = x.to(torch.int64)
    wi = w.to(torch.int64)
    if int4:
        xi, wi = _sext4(xi), _sext4(wi)
    wd = wi.double()
    for r in range(rounds):
        acc = sum(xi.double() @ wd[p] for p in range(wd.shape[0])).to(torch.int64)
        xi = (acc + r) & 0xF
        if int4:
            xi = _sext4(xi)
    return xi.to(torch.int8)


def prepare_weights(w, inst: str, int4: bool):
    """The route's weights from (panels, K, N) int8: dp4a as they are, the
    tensor-core routes transposed to (panels, N, K) (int8 or bf16), int4 as
    nibbles (panels, N, K/2), k even in the low nibble."""
    if inst == "dp4a":
        return w.contiguous()
    wt = w.transpose(1, 2)
    if int4:
        wt = _sext4(wt.to(torch.int32)).to(torch.int8)
    if inst == "mma_s8":
        return wt.contiguous()
    if inst == "mma_bf16":
        return wt.to(torch.bfloat16).contiguous()
    nib = wt.to(torch.int32) & 0xF
    packed = nib[..., 0::2] | (nib[..., 1::2] << 4)
    return ((packed + 128) % 256 - 128).to(torch.int8).contiguous()


def probe(x, w_route, inst: str, int4: bool, rounds: int):
    """One call of the route's kernel on the card (counted under
    ``probe_<inst>``): x (..., rows, K) int8, ``w_route`` the route's
    weights (`prepare_weights`)."""
    if inst not in INSTRUCTIONS or (inst == "mma_s4" and not int4):
        raise ValueError(f"no probe route {inst!r} in the {'int4' if int4 else 'int8'} form")
    K = x.shape[-1]
    R = x.numel() // K
    panels = w_route.shape[0]
    N = w_route.shape[1] if inst != "dp4a" else w_route.shape[2]
    _build.require(x, "x", torch.int8, x.shape)
    if K % 64 != 0 or N != K or R < 1:
        raise ValueError(f"the probe needs N == K, K % 64 == 0 and rows (K={K}, N={N}, rows={R})")
    if inst == "mma_bf16" and panels * K * 15 * 128 >= _BF16_EXACT:
        raise ValueError(f"bf16 sums are exact only below 2**24: panels * K = {panels * K}")
    out = torch.empty_like(x)
    err = _build.lib("probe_int4").ff_probe_int4(
        x.data_ptr(), w_route.data_ptr(), out.data_ptr(), R, K, N, panels, rounds, int(int4),
        INSTRUCTIONS[inst], _build.stream_ptr(x.device))
    name = f"probe_{inst}"
    _build.launch_counts[name] += 1
    _build.check(err, name)
    return out


def make_probe(int4: bool, inst: str, rounds: int):
    """The probe of one route as a function of (x, w), w (panels, K, N)
    int8: `scripts/tpu_probe_int4.py`'s make_probe for one instruction.
    A CPU x runs the plain version, a CUDA x the route's kernel."""

    def one(x, w):
        if x.device.type == "cpu":
            return probe_reference(x, w, int4, rounds)
        return probe(x, prepare_weights(w, inst, int4), inst, int4, rounds)

    return one


def inputs(knobs: Knobs, copies: int, device, seed: int = 0):
    """The TPU probe's inputs from the seed: x (copies, BM, K) in [0, 15],
    distinct per copy, and w (panels, K, N) in [-8, 7]."""
    rng = np.random.RandomState(seed)
    x = rng.randint(0, 16, (copies, knobs.bm, knobs.k)).astype(np.int8)
    w = rng.randint(-8, 8, (knobs.panels, knobs.k, knobs.n)).astype(np.int8)
    return torch.from_numpy(x).to(device), torch.from_numpy(w).to(device)


def ops_per_call(knobs: Knobs, copies: int) -> int:
    return 2 * copies * knobs.bm * knobs.k * knobs.n * knobs.panels * knobs.rounds


def time_routes(knobs: Knobs, x, w, scan: int, pairs: int):
    """Best ms of ``scan`` chained calls of each route of ``ROUTES``, its
    passes interleaved with the other routes' (``pairs`` times), CUDA
    events around each pass; and each route's output after one call, with
    the plain version's. Returns {(inst, int4): (best ms a call, out, ref)}."""
    prepped = {r: prepare_weights(w, *r) for r in ROUTES}
    best = {r: float("inf") for r in ROUTES}
    for _ in range(pairs):
        for inst, int4 in ROUTES:
            y = x
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(scan):
                y = probe(y, prepped[inst, int4], inst, int4, knobs.rounds)
            end.record()
            torch.cuda.synchronize()
            best[inst, int4] = min(best[inst, int4], start.elapsed_time(end) / scan)
    checked = {}
    for inst, int4 in ROUTES:
        out = probe(x, prepped[inst, int4], inst, int4, knobs.rounds)
        checked[inst, int4] = (best[inst, int4], out, probe_reference(x, w, int4, knobs.rounds))
    return checked


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_int4: CUDA is not available", file=sys.stderr)
        return 2
    knobs = Knobs.from_env()
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    copies = knobs.copies or default_copies(knobs.bm, sms)
    x, w = inputs(knobs, copies, dev)
    ops = ops_per_call(knobs, copies)
    print(f"{torch.cuda.get_device_name(dev)}, {sms} SMs; {copies} copies of ({knobs.bm},"
          f"{knobs.k})@({knobs.k},{knobs.n}) x {knobs.panels} panels x {knobs.rounds} rounds = "
          f"{ops / 1e12:.3f} TOP a call, {knobs.scan} calls chained, best of {knobs.pairs}")
    ok = True
    for (inst, int4), (ms, out, ref) in time_routes(knobs, x, w, knobs.scan,
                                                    knobs.pairs).items():
        same = torch.equal(out.cpu(), ref.cpu())
        ok &= same
        tops = ops / (ms * 1e-3) / 1e12
        print(f"{inst:9s} {'int4' if int4 else 'int8'} form: {ms:.4f} ms a call, {tops:.1f} TOP/s "
              f"({tops / sms:.3f} TOP/s per SM); output {'equals' if same else 'DIFFERS FROM'} "
              "the plain version's")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
