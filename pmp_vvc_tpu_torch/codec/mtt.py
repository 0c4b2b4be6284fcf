"""MTT split legality + split_cu_mode syntax (single-tree luma, intra).

Contracts:
- legality: QTBTPartitioner::canSplit (UnitPartitioner.cpp:371-468):
  no QT below MTT, min/max BT/TT sizes (min sizes = MinCbSize), 64-sample
  max-TB interaction, TT-middle parallel-BT ban.
- syntax + contexts: CABACWriter::split_cu_mode (CABACWriter.cpp:567) and
  DeriveCtx::CtxSplit (ContextModelling.cpp:131).

The encoder uses a MinCbSize-8 configuration for MTT streams so the
single-tree small-chroma (SCIPU / local dual tree) machinery is never
triggered; 4-size CUs are then illegal by SPS, matching the decoder's
inference.
"""
from __future__ import annotations

from dataclasses import dataclass

from .partition import Split
from .residual import ctx

MAX_TB = 64


@dataclass(frozen=True)
class SplitState:
    """Per-node state the legality rules depend on."""

    last_split: Split = Split.NONE      # split that created this node
    part_idx: int = 0                   # index among siblings
    qt_depth: int = 0
    mtt_depth: int = 0
    implicit_bt_depth: int = 0          # implicit BT splits on this path


def get_implicit_split(x, y, w, h, state: SplitState, cfg,
                       chroma: bool = False) -> Split:
    """QTBTPartitioner::getImplicitSplit (UnitPartitioner.cpp:607-659).

    Forced split for CUs that overflow the picture boundary (plus the
    dual-tree >64 implicit QT).  Caller guarantees (x, y) is inside the
    picture.
    """
    bl_in = y + h <= cfg.height            # bottom-left in picture
    tr_in = x + w <= cfg.width             # top-right in picture
    min_qt = cfg.chroma_min_qt if chroma else cfg.min_qt_intra
    max_bt = cfg.chroma_max_bt if chroma else cfg.max_bt_intra
    max_btd = (cfg.chroma_max_mtt_depth if chroma
               else cfg.max_mtt_depth_intra) + state.implicit_bt_depth
    split = Split.NONE
    bt_ok = w <= max_bt and h <= max_bt and state.mtt_depth < max_btd
    qt_ok = w > min_qt and h > min_qt and state.mtt_depth == 0
    if not bl_in and not tr_in and qt_ok:
        split = Split.QT
    elif not bl_in and bt_ok and w <= MAX_TB:
        split = Split.BT_H
    elif not tr_in and bt_ok and h <= MAX_TB:
        split = Split.BT_V
    elif not bl_in or not tr_in:
        split = Split.QT
    if cfg.dual_tree and (w > 64 or h > 64):
        split = Split.QT
    if (not bl_in or not tr_in) and split == Split.NONE:
        split = Split.QT
    return split


def can_split_set(w, h, state: SplitState, cfg, chroma: bool = False,
                  implicit: Split = Split.NONE):
    """canSplit (luma or dual-tree-chroma channel), non-boundary.

    ``w``/``h`` in luma units for both channels (the reference compares
    the luma-projected area against luma-unit thresholds and applies
    extra chroma-sample bans, UnitPartitioner.cpp:398-431).
    """
    min_cb = 1 << cfg.log2_min_cb
    min_bt = min_tt = min_cb
    max_btd = cfg.chroma_max_mtt_depth if chroma else cfg.max_mtt_depth_intra
    min_qt = cfg.chroma_min_qt if chroma else cfg.min_qt_intra
    max_bt = cfg.chroma_max_bt if chroma else cfg.max_bt_intra
    max_tt = cfg.chroma_max_tt if chroma else cfg.max_tt_intra
    can = {Split.NONE: True, Split.QT: True, Split.BT_H: True,
           Split.BT_V: True, Split.TT_H: True, Split.TT_V: True}

    can_btt = state.mtt_depth < (max_btd + state.implicit_bt_depth)
    if state.last_split not in (Split.NONE, Split.QT):
        can[Split.QT] = False
    if w <= min_qt:
        can[Split.QT] = False
    if chroma:
        cw, chh = w // 2, h // 2        # 4:2:0 chroma samples
        if cw <= 4:
            can[Split.QT] = False
    if implicit != Split.NONE:
        # boundary CU: only the implicit BT (or QT) may be taken
        # (UnitPartitioner.cpp:409-418)
        can[Split.NONE] = can[Split.TT_H] = can[Split.TT_V] = False
        can[Split.BT_H] = implicit == Split.BT_H
        can[Split.BT_V] = implicit == Split.BT_V
        if chroma and w // 2 == 4:
            can[Split.BT_V] = False
        if not can[Split.BT_H] and not can[Split.BT_V] \
                and not can[Split.QT]:
            can[Split.QT] = True
        return can
    if state.last_split in (Split.TT_H, Split.TT_V) and state.part_idx == 1:
        # middle TT child can't repeat the parallel BT split
        if state.last_split == Split.TT_H:
            can[Split.BT_H] = False
        else:
            can[Split.BT_V] = False
    if can_btt and (w <= min_bt and h <= min_bt) \
            and (w <= min_tt and h <= min_tt):
        can_btt = False
    if can_btt and (w > max_bt or h > max_bt) \
            and (w > max_tt or h > max_tt):
        can_btt = False
    if not can_btt:
        can[Split.BT_H] = can[Split.BT_V] = False
        can[Split.TT_H] = can[Split.TT_V] = False
        return can
    if w > max_bt or h > max_bt:
        can[Split.BT_H] = can[Split.BT_V] = False
    if h <= min_bt:
        can[Split.BT_H] = False
    if w > MAX_TB and h <= MAX_TB:
        can[Split.BT_H] = False
    if w <= min_bt:
        can[Split.BT_V] = False
    if w <= MAX_TB and h > MAX_TB:
        can[Split.BT_V] = False
    if h <= 2 * min_tt or h > max_tt or w > max_tt:
        can[Split.TT_H] = False
    if w > MAX_TB or h > MAX_TB:
        can[Split.TT_H] = False
    if w <= 2 * min_tt or w > max_tt or h > max_tt:
        can[Split.TT_V] = False
    if w > MAX_TB or h > MAX_TB:
        can[Split.TT_V] = False
    if chroma:
        cw, chh = w // 2, h // 2
        if cw * chh <= 16:
            can[Split.BT_H] = False
        if cw * chh <= 16 or cw == 4:
            can[Split.BT_V] = False
        if cw * chh <= 32:
            can[Split.TT_H] = False
        if cw * chh <= 32 or cw == 8:
            can[Split.TT_V] = False
    return can


def derive_split_ctx(w, h, state: SplitState, can, left, above):
    """DeriveCtx::CtxSplit. ``left``/``above`` = (w, h, qt_depth) or None."""
    ctx_spl = 0
    if left:
        ctx_spl += 1 if left[1] < h else 0
    if above:
        ctx_spl += 1 if above[0] < w else 0
    num_split = (2 if can[Split.QT] else 0) \
        + (1 if can[Split.BT_H] else 0) + (1 if can[Split.BT_V] else 0) \
        + (1 if can[Split.TT_H] else 0) + (1 if can[Split.TT_V] else 0)
    if num_split > 0:
        num_split -= 1
    ctx_spl += 3 * (num_split >> 1)

    ctx_qt = (1 if left and left[2] > state.qt_depth else 0) \
        + (1 if above and above[2] > state.qt_depth else 0) \
        + (0 if state.qt_depth < 2 else 3)

    num_hor = (1 if can[Split.BT_H] else 0) + (1 if can[Split.TT_H] else 0)
    num_ver = (1 if can[Split.BT_V] else 0) + (1 if can[Split.TT_V] else 0)
    if num_ver == num_hor:
        w_above = above[0] if above else 1
        h_left = left[1] if left else 1
        dep_above = w // w_above
        dep_left = h // h_left
        if dep_above == dep_left or not left or not above:
            ctx_hv = 0
        elif dep_above < dep_left:
            ctx_hv = 1
        else:
            ctx_hv = 2
    elif num_ver < num_hor:
        ctx_hv = 3
    else:
        ctx_hv = 4

    ctx_hor_bt = 1 if state.mtt_depth <= 1 else 0
    ctx_ver_bt = 3 if state.mtt_depth <= 1 else 2
    return ctx_spl, ctx_qt, ctx_hv, ctx_hor_bt, ctx_ver_bt


def write_split_cu_mode(enc, split: Split, w, h, state: SplitState, cfg,
                        left, above, chroma: bool = False,
                        implicit: Split = Split.NONE):
    """CABACWriter::split_cu_mode bin sequence."""
    can = can_split_set(w, h, state, cfg, chroma, implicit)
    ctx_spl, ctx_qt, ctx_hv, ctx_h12, ctx_v12 = derive_split_ctx(
        w, h, state, can, left, above)
    can_split = any(can[s] for s in (Split.QT, Split.BT_H, Split.BT_V,
                                     Split.TT_H, Split.TT_V))
    is_no = split == Split.NONE
    assert can[split], (split, w, h, state)
    if can[Split.NONE] and can_split:
        enc.encode_bin(0 if is_no else 1, ctx("SplitFlag", ctx_spl))
    if is_no:
        return
    can_btt = any(can[s] for s in (Split.BT_H, Split.BT_V,
                                   Split.TT_H, Split.TT_V))
    is_qt = split == Split.QT
    if can[Split.QT] and can_btt:
        enc.encode_bin(1 if is_qt else 0, ctx("SplitQtFlag", ctx_qt))
    if is_qt:
        return
    can_hor = can[Split.BT_H] or can[Split.TT_H]
    can_ver = can[Split.BT_V] or can[Split.TT_V]
    is_ver = split in (Split.BT_V, Split.TT_V)
    if can_ver and can_hor:
        enc.encode_bin(1 if is_ver else 0, ctx("SplitHvFlag", ctx_hv))
    can14 = can[Split.TT_V] if is_ver else can[Split.TT_H]
    can12 = can[Split.BT_V] if is_ver else can[Split.BT_H]
    is12 = split in (Split.BT_V, Split.BT_H)
    if can12 and can14:
        enc.encode_bin(1 if is12 else 0,
                       ctx("Split12Flag", ctx_v12 if is_ver else ctx_h12))


def parse_split_cu_mode(dec, w, h, state: SplitState, cfg, left, above,
                        chroma: bool = False,
                        implicit: Split = Split.NONE) -> Split:
    """CABACReader::split_cu_mode — exact parse mirror of
    ``write_split_cu_mode`` (same legality set + contexts, bins read
    only where the encoder wrote them, everything else inferred)."""
    can = can_split_set(w, h, state, cfg, chroma, implicit)
    ctx_spl, ctx_qt, ctx_hv, ctx_h12, ctx_v12 = derive_split_ctx(
        w, h, state, can, left, above)
    can_split = any(can[s] for s in (Split.QT, Split.BT_H, Split.BT_V,
                                     Split.TT_H, Split.TT_V))
    if can[Split.NONE] and can_split:
        if dec.decode_bin(ctx("SplitFlag", ctx_spl)) == 0:
            return Split.NONE
    elif can[Split.NONE]:
        return Split.NONE
    can_btt = any(can[s] for s in (Split.BT_H, Split.BT_V,
                                   Split.TT_H, Split.TT_V))
    if can[Split.QT] and can_btt:
        if dec.decode_bin(ctx("SplitQtFlag", ctx_qt)):
            return Split.QT
    elif can[Split.QT]:
        return Split.QT
    can_hor = can[Split.BT_H] or can[Split.TT_H]
    can_ver = can[Split.BT_V] or can[Split.TT_V]
    if can_ver and can_hor:
        is_ver = bool(dec.decode_bin(ctx("SplitHvFlag", ctx_hv)))
    else:
        is_ver = can_ver
    can14 = can[Split.TT_V] if is_ver else can[Split.TT_H]
    can12 = can[Split.BT_V] if is_ver else can[Split.BT_H]
    if can12 and can14:
        is12 = bool(dec.decode_bin(
            ctx("Split12Flag", ctx_v12 if is_ver else ctx_h12)))
    else:
        is12 = can12
    if is_ver:
        return Split.BT_V if is12 else Split.TT_V
    return Split.BT_H if is12 else Split.TT_H
