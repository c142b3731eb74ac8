"""Initial population (port of ``attacks/moeva/initialisation.py``).

Only the ``tile`` strategy is ported: every individual starts at the encoded
initial state with integer genes rounded. ``lp_ratio`` is not ported yet.
"""

from __future__ import annotations

import torch

from ...core import codec as codec_lib
from ...core.codec import Codec


def tile_init(codec: Codec, x_init_ml: torch.Tensor, n_pop: int) -> torch.Tensor:
    """(S, D) initial states -> (S, n_pop, L) genetic population."""
    x0 = codec_lib.round_int_genes(codec, codec_lib.ml_to_genetic(codec, x_init_ml))
    return x0[:, None, :].expand(x0.shape[0], n_pop, codec.gen_length).contiguous()
