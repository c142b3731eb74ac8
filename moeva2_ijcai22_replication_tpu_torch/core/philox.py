"""The port's one source of random numbers: Philox4x32-10, counter based.

The JAX package draws inside its device programs from threefry keys
(``attacks/moeva/operators.py``'s parents, cuts, coins and mutation draws,
``survival.py``'s niching gumbels, ``initialisation.py``'s ball,
``attacks/pgd/engine.py``'s random start). The port cannot reproduce those
bits; it draws from Philox4x32-10 (Salmon, Moraes, Dror and Shaw, "Parallel
random numbers: as easy as 1, 2, 3", SC'11, the generator of Random123),
which maps a 128-bit counter and a 64-bit key to four 32-bit words with no
state but the counter. Kernel K0 (``kernels/csrc/draws.cu``) computes it on
the card, each thread its own counters; :func:`draw_plain` here is its plain
version, in int64 PyTorch arithmetic on any device.

**The stream.** A :class:`PhiloxStream` is ``(key, next block)``: the key
is the attack's seed (its low and high 32 bits), and a block is one counter
value ``(n mod 2**32, n >> 32, 0, 0)`` and the four words it gives. Each
call (:meth:`PhiloxStream.draw`) takes the next run of blocks, so no two
calls share a counter; its state is a 2-entry int64 tensor
(:meth:`~PhiloxStream.get_state`) that a checkpoint carries.

**The field layout.** A call draws an ordered list of :class:`Field` s. The
fields take consecutive runs of the call's blocks, in list order, each
starting on a block of its own: field f's element i lies in block
``base + first_f + i // per`` at slot ``i % per``, where ``per`` is the
elements a block gives for the field's kind and dtype (:func:`per_block`)
and ``first_f`` the blocks of the fields before it (:func:`layout`). No
block serves two fields or two calls. The same layout holds on the CPU and
on the card.

**Words to values**, written once here and repeated exactly by K0 (w is a
32-bit word; a block's words are w0..w3):

- ``UNIFORM`` float32: ``(w >> 8) * 2**-24``, a word an element; float64:
  ``((a >> 5) * 2**26 + (b >> 6)) * 2**-53`` from the words (w0, w1) and
  (w2, w3), two elements a block. Both lie in [0, 1) and are exact;
- ``SYMMETRIC``: ``2 u - 1`` of the dtype's uniform, in [-1, 1), exact;
- ``INTEGER`` in [0, n): ``(w * n) >> 32``, a word an element (the
  multiply-shift map; its bias is below n / 2**32);
- ``CUT`` in [0, 2**30): ``w >> 2``;
- ``GUMBEL``: ``-log(-log(max(u, tiny)))`` of the dtype's uniform u, in
  float64 and rounded once to the dtype (``tiny`` the dtype's smallest
  normal);
- ``NORMAL``: Box-Muller in float64 from the 53-bit uniforms u1 (w0, w1)
  and u2 (w2, w3): ``r = sqrt(-2 log(1 - u1))``, ``t = 2 pi * u2``,
  elements ``r cos t`` and ``r sin t``, each rounded once to the dtype; two
  elements a block in either dtype.

The integer and uniform fields are the same bits on every device. GUMBEL
and NORMAL round a float64 ``log``, ``cos`` or ``sin``, which the CPU's and
CUDA's math libraries may round differently in rare elements; on the card
K0 and :func:`draw_plain` both use CUDA's, and agree bit for bit.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

UNIFORM, SYMMETRIC, INTEGER, CUT, GUMBEL, NORMAL = range(6)
KIND_NAMES = ("uniform", "symmetric", "integer", "cut", "gumbel", "normal")
#: the name of this stream, which a checkpoint records beside its state
STREAM = "philox4x32-10"

_MASK = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_ROUNDS = 10
#: 2 pi rounded to float64, the Box-Muller angle's factor (K0's ``kTwoPi``)
TWO_PI = 2.0 * math.pi


class Field(NamedTuple):
    """One field of a call: its name, kind, shape and, for ``INTEGER``, the
    exclusive upper bound ``n``."""

    name: str
    kind: int
    shape: tuple
    n: int = 0

    @property
    def numel(self) -> int:
        return math.prod(self.shape)


def out_dtype(field: Field, dtype: torch.dtype) -> torch.dtype:
    """The dtype of a field's values: int64 for integers and cuts, else the
    call's float dtype."""
    return torch.int64 if field.kind in (INTEGER, CUT) else dtype


def per_block(kind: int, dtype: torch.dtype) -> int:
    """Elements one block gives: 4 for integers, cuts and float32 uniforms
    (and their symmetric and gumbel forms), 2 for float64 ones and for
    normals."""
    if kind in (INTEGER, CUT):
        return 4
    if kind == NORMAL or dtype == torch.float64:
        return 2
    if dtype == torch.float32:
        return 4
    raise TypeError(f"draws are float32 or float64, not {dtype}")


def layout(fields, dtype: torch.dtype) -> tuple:
    """``(first, total)``: each field's first block relative to the call's
    base, and the blocks the call takes."""
    first, total = [], 0
    for f in fields:
        if f.kind == INTEGER and not 0 < f.n < 2**31:
            raise ValueError(f"field {f.name!r}: an integer bound must lie in [1, 2**31), got {f.n}")
        first.append(total)
        total += -(-f.numel // per_block(f.kind, dtype))
    return tuple(first), total


def _mulhilo(a: torch.Tensor, m: int):
    """``(hi, lo)`` 32-bit halves of ``a * m`` for int64 ``a`` in [0, 2**32)
    and ``m`` < 2**32, with no int64 product above 2**49."""
    p_lo = a * (m & 0xFFFF)
    p_hi = a * (m >> 16)
    lo = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (lo >> 32), lo & _MASK


def philox4x32(counter: torch.Tensor, key: tuple) -> torch.Tensor:
    """Philox4x32-10 of ``counter`` (..., 4) int64 words in [0, 2**32) under
    ``key`` (k0, k1): (..., 4) int64 words, Random123's ``philox4x32_R(10,
    ...)``."""
    c0, c1, c2, c3 = counter.unbind(-1)
    k0, k1 = int(key[0]) & _MASK, int(key[1]) & _MASK
    for r in range(_ROUNDS):
        if r:
            k0, k1 = (k0 + _W0) & _MASK, (k1 + _W1) & _MASK
        hi0, lo0 = _mulhilo(c0, _M0)
        hi1, lo1 = _mulhilo(c2, _M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return torch.stack([c0, c1, c2, c3], -1)


def block_words(key: int, first: int, n_blocks: int, device) -> torch.Tensor:
    """(n_blocks, 4) words of the blocks ``first`` .. ``first + n_blocks -
    1`` under the 64-bit ``key``."""
    n = first + torch.arange(n_blocks, dtype=torch.int64, device=device)
    zero = torch.zeros_like(n)
    return philox4x32(torch.stack([n & _MASK, n >> 32, zero, zero], -1), (key & _MASK, key >> 32))


def _uniform(words: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(B, 4) words -> (B, per) uniforms of ``dtype`` in [0, 1)."""
    if dtype == torch.float32:
        return (words >> 8).to(torch.float32) * 2.0**-24
    return _uniform53(words[:, 0::2], words[:, 1::2])


def _uniform53(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (((a >> 5) << 26) + (b >> 6)).to(torch.float64) * 2.0**-53


def field_values(words: torch.Tensor, field: Field, dtype: torch.dtype) -> torch.Tensor:
    """The values of ``field`` from its (B, 4) block words, in its shape."""
    k = field.kind
    if k == INTEGER:
        v = (words * field.n) >> 32
    elif k == CUT:
        v = words >> 2
    elif k == UNIFORM:
        v = _uniform(words, dtype)
    elif k == SYMMETRIC:
        v = 2.0 * _uniform(words, dtype) - 1.0
    elif k == GUMBEL:
        u = _uniform(words, dtype).double().clamp(min=torch.finfo(dtype).tiny)
        v = (-torch.log(-torch.log(u))).to(dtype)
    elif k == NORMAL:
        u1 = _uniform53(words[:, 0], words[:, 1])
        u2 = _uniform53(words[:, 2], words[:, 3])
        r = torch.sqrt(-2.0 * torch.log(1.0 - u1))
        t = u2 * TWO_PI
        v = torch.stack([r * torch.cos(t), r * torch.sin(t)], -1).to(dtype)
    else:
        raise ValueError(f"unknown draw kind {k}")
    return v.reshape(-1)[: field.numel].reshape(field.shape)


def draw_plain(fields, dtype: torch.dtype, key: int, base: int, device) -> dict:
    """Kernel K0's plain version: each field of one call whose first block
    is ``base``, as a tensor on ``device`` (:func:`field_values` of its
    blocks)."""
    first, _ = layout(fields, dtype)
    out = {}
    for f, b0 in zip(fields, first):
        n_blocks = -(-f.numel // per_block(f.kind, dtype))
        out[f.name] = field_values(block_words(key, base + b0, n_blocks, device), f, dtype)
    return out


def _signed(v: int) -> int:
    return v - (1 << 64) if v >= 1 << 63 else v


class PhiloxStream:
    """``(key, next block)`` on ``device``. :meth:`draw` takes the next run
    of blocks for a call's fields: kernel K0 on the card, :func:`draw_plain`
    on the CPU."""

    def __init__(self, seed: int, device="cpu"):
        self.key = int(seed) & (2**64 - 1)
        self.counter = 0
        self.device = torch.device(device)

    def take(self, n_blocks: int) -> int:
        """The first of the next ``n_blocks`` blocks, which the stream then
        skips."""
        base = self.counter
        if base + n_blocks >= 2**63:
            raise OverflowError("the Philox stream's 2**63 blocks are spent")
        self.counter = base + n_blocks
        return base

    def draw(self, fields, dtype: torch.dtype = torch.float32) -> dict:
        """Each of ``fields`` (a list of :class:`Field`) drawn in one call:
        ``{name: tensor}``, one launch of K0 on the card."""
        fields = list(fields)
        base = self.take(layout(fields, dtype)[1])
        if self.device.type == "cuda":
            from ..kernels import draws

            return draws(fields, dtype, self.key, base, self.device)
        return draw_plain(fields, dtype, self.key, base, self.device)

    def get_state(self) -> torch.Tensor:
        """(2,) int64 ``[key, next block]`` on the CPU (the key's 64 bits
        as a signed integer)."""
        return torch.tensor([_signed(self.key), self.counter], dtype=torch.int64)

    def set_state(self, state: torch.Tensor) -> None:
        state = torch.as_tensor(state)
        if state.dtype != torch.int64 or tuple(state.shape) != (2,):
            raise ValueError(
                f"a Philox stream's state is (2,) int64 [key, next block], got {state.dtype} "
                f"{tuple(state.shape)}: a torch.Generator's state from before the port drew from Philox "
                "cannot resume this stream"
            )
        key, counter = (int(v) for v in state.tolist())
        self.key, self.counter = key & (2**64 - 1), counter
