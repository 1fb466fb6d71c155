"""Carry state across from the JAX package.

This system has no learned weights: its parameters are the code tables, the
beta ladder (numpy in both packages), the ladder state and the
shortest-chain tracking state.  These helpers
let both packages compute on identical inputs; none of them imports jax.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from .decoders.pteq import ShortestState
from .mcmc.ladder import LadderState, PermLadderState
from .models.base import CodeSpec, LogicalDraw


def spec_from_jax(jax_spec) -> CodeSpec:
    """Port ``CodeSpec`` with the fields of an ``mcmc_qec_tpu`` one, read by
    attribute (numpy arrays are copied)."""
    fields = {}
    for f in dataclasses.fields(CodeSpec):
        v = getattr(jax_spec, f.name)
        if f.name == "logical_draws":
            v = tuple(
                LogicalDraw(
                    x_masks=np.array(d.x_masks),
                    z_masks=np.array(d.z_masks),
                    op_lut=np.array(d.op_lut),
                )
                for d in v
            )
        elif isinstance(v, np.ndarray):
            v = v.copy()
        fields[f.name] = v
    return CodeSpec(**fields)


def ladder_state_from_numpy(state, flag, tops0, device) -> LadderState:
    """LadderState on ``device`` from numpy (B, Nc, nq) u8 states, (B, Nc)
    flags and (B,) tops0."""
    return LadderState(
        state=torch.as_tensor(np.asarray(state, np.uint8), device=device),
        flag=torch.as_tensor(np.asarray(flag, np.int32), device=device),
        tops0=torch.as_tensor(np.asarray(tops0, np.int32), device=device),
    )


def ladder_state_to_numpy(ls: LadderState) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(state, flag, tops0) numpy arrays of a LadderState."""
    return tuple(t.detach().cpu().numpy() for t in ls)


def perm_ladder_state_from_numpy(state, flag, tops0, pos,
                                 device) -> PermLadderState:
    """PermLadderState on ``device`` from numpy (B, Nc, nq) u8 states in
    physical order, (B, Nc) per-chain flags, (B,) tops0 and (B, Nc) rung
    positions (the fields of the JAX package's ``PermLadderState``, in its
    order; ``pos`` is held as int64)."""
    return PermLadderState(
        state=torch.as_tensor(np.asarray(state, np.uint8), device=device),
        flag=torch.as_tensor(np.asarray(flag, np.int32), device=device),
        tops0=torch.as_tensor(np.asarray(tops0, np.int32), device=device),
        pos=torch.as_tensor(np.asarray(pos, np.int64), device=device),
    )


def perm_ladder_state_to_numpy(pls: PermLadderState) -> Tuple[np.ndarray, ...]:
    """(state, flag, tops0, pos) numpy arrays of a PermLadderState, ``pos``
    as int32 like the JAX package's."""
    state, flag, tops0, pos = (t.detach().cpu().numpy() for t in pls)
    return state, flag, tops0, pos.astype(np.int32)


def shortest_state_from_numpy(val, cnt, nuq, ovf, keys, device) -> ShortestState:
    """ShortestState on ``device`` from numpy (B, K) f32 val, i32 cnt and
    nuq, bool ovf and (B, K, U, 4) i32 keys (the fields of the JAX
    package's ``ShortestState``, in its order), copied."""
    return ShortestState(
        val=torch.as_tensor(np.array(val, np.float32), device=device),
        cnt=torch.as_tensor(np.array(cnt, np.int32), device=device),
        nuq=torch.as_tensor(np.array(nuq, np.int32), device=device),
        ovf=torch.as_tensor(np.array(ovf, bool), device=device),
        keys=torch.as_tensor(np.array(keys, np.int32), device=device),
    )


def shortest_state_to_numpy(sh: ShortestState) -> Tuple[np.ndarray, ...]:
    """(val, cnt, nuq, ovf, keys) numpy arrays of a ShortestState."""
    return tuple(t.detach().cpu().numpy() for t in sh)
