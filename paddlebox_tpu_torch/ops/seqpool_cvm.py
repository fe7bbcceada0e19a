"""Fused sequence sum-pool + CVM transform, with the full variant family
(reference: paddlebox_tpu/ops/seqpool_cvm.py).

The host feed packs a batch as one padded CSR (HostBatch.key_segments,
segment id = ins * S + slot, padding -> overflow bin B*S), so every variant
is three stages on static shapes:

  1. per-occurrence prep (``_prepool``): the show/clk score filter (a
     scalar or a per-slot threshold), the embed-norm filter and the
     quantization of the embed columns, as row masks;
  2. one segment sum over all slots (``seqpool``);
  3. a row-layout CVM transform (``default`` / ``conv`` / ``pcoc``).

Row layouts of a pulled value:

  default: [show, click,           embed...]              cvm_offset = 2
  conv:    [show, click, conv,     embed...]              cvm_offset = 3
  pcoc:    [show, click, d0, d1, q_0..q_{p-1}, embed...]  cvm_offset = 4+p

Counters carry no gradient (the reference's cvm_grad does not learn them),
filtered occurrences contribute nothing and receive zero gradient, the
quantization is straight-through, and padding falls into the dropped
overflow bin, so it contributes nothing and receives zero gradient.
"""

from __future__ import annotations

import torch


def seqpool(rows: torch.Tensor, key_segments: torch.Tensor, batch_size: int,
            n_slots: int) -> torch.Tensor:
    """Sum-pool pulled rows [K, W] into [batch_size, n_slots, W].  The
    overflow bin's padding spreads over dropped rows
    (sparse/table.py:spread_sink): the same sums, without one bin of every
    padding occurrence for a deterministic index_add to serialize."""
    from paddlebox_tpu_torch.sparse.table import SINK_SPREAD, spread_sink

    bins = batch_size * n_slots
    pooled = torch.zeros(
        (bins + SINK_SPREAD, rows.shape[1]),
        dtype=rows.dtype, device=rows.device,
    ).index_add(0, spread_sink(key_segments, bins), rows)
    return pooled[:bins].reshape(batch_size, n_slots, -1)


def _quant_round(v: torch.Tensor, quant_ratio: int) -> torch.Tensor:
    """``int(v * ratio + 0.5) / ratio`` (C truncation toward zero), with the
    gradient of the identity (straight-through)."""
    q = torch.trunc(v * quant_ratio + 0.5) / quant_ratio
    return v + (q - v).detach()


def _prepool(rows, key_segments, n_slots: int, cvm_offset: int,
             need_filter: bool, show_coeff: float, clk_coeff: float,
             threshold: float, threshold_vec, embed_threshold: float,
             quant_ratio: int) -> torch.Tensor:
    """The per-occurrence filter and quantization stage.  An occurrence
    survives when ``(show - click) * show_coeff + click * clk_coeff >=
    thr[slot]`` (``threshold``, or the per-slot ``threshold_vec``) and,
    with ``embed_threshold`` > 0, ``|embed_w| + ||embedx||_2 >=
    embed_threshold``.  A filtered occurrence contributes nothing, its
    counters included."""
    if need_filter:
        show, click = rows[:, 0], rows[:, 1]
        if threshold_vec is not None:
            thr_vec = torch.as_tensor(threshold_vec, dtype=rows.dtype,
                                      device=rows.device)
            thr = thr_vec[key_segments % n_slots]
        else:
            thr = threshold
        keep = (show - click) * show_coeff + click * clk_coeff >= thr
        if embed_threshold > 0.0:
            embed_w = rows[:, cvm_offset]
            embedx = rows[:, cvm_offset + 1:]
            score = torch.sqrt((embedx * embedx).sum(1)) + torch.abs(embed_w)
            keep = keep & (score >= embed_threshold)
        rows = rows * keep.to(rows.dtype)[:, None].detach()
    if quant_ratio > 0:
        rows = torch.cat([rows[:, :cvm_offset],
                          _quant_round(rows[:, cvm_offset:], quant_ratio)],
                         dim=1)
    return rows


def pooled_width(emb_width: int, cvm_offset: int = 2, use_cvm: bool = True,
                 layout: str = "default", show_filter: bool = False) -> int:
    """Per-slot output width of the family, the width every model's input
    accounting uses: the default CVM emits 2 counter columns ([log_show,
    ctr]), the conv layout 3 ([log_show, log_clk, cvr], one fewer with
    show_filter); without use_cvm the counter columns are dropped."""
    embed = emb_width - cvm_offset
    if not use_cvm:
        return embed
    if layout == "conv":
        return 3 + embed - (1 if show_filter else 0)
    return 2 + embed


def _cvm_transform(pooled: torch.Tensor, cvm_offset: int) -> torch.Tensor:
    """Log-CVM on the pooled show/click columns, counters stop-gradient."""
    show = pooled[..., 0:1].detach()
    click = pooled[..., 1:2].detach()
    log_show = torch.log(show + 1.0)
    ctr = torch.log(click + 1.0) - log_show
    return torch.cat([log_show, ctr, pooled[..., cvm_offset:]], dim=-1)


def fused_seqpool_cvm(
    rows: torch.Tensor,
    key_segments: torch.Tensor,
    batch_size: int,
    n_slots: int,
    use_cvm: bool = True,
    cvm_offset: int = 2,
    clk_coeff: float = 1.0,
    need_filter: bool = False,
    show_coeff: float = 0.2,
    threshold: float = 0.0,
    threshold_vec=None,
    embed_threshold: float = 0.0,
    quant_ratio: int = 0,
) -> torch.Tensor:
    """Pool + CVM for all slots at once: [B, n_slots * pooled_width(...)].
    ``threshold_vec`` (length n_slots) gives the show/clk filter per-slot
    thresholds (the _with_diff_thres variant); ``quant_ratio`` > 0
    quantizes the embed columns of each occurrence before pooling."""
    rows = _prepool(rows, key_segments, n_slots, cvm_offset, need_filter,
                    show_coeff, clk_coeff, threshold, threshold_vec,
                    embed_threshold, quant_ratio)
    pooled = seqpool(rows, key_segments, batch_size, n_slots)
    if use_cvm:
        out = _cvm_transform(pooled, cvm_offset)
    else:
        out = pooled[..., cvm_offset:]
    return out.reshape(batch_size, -1)


def fused_seqpool_cvm_with_diff_thres(
    rows: torch.Tensor,
    key_segments: torch.Tensor,
    batch_size: int,
    n_slots: int,
    threshold_vec,
    use_cvm: bool = True,
    cvm_offset: int = 2,
    show_coeff: float = 0.2,
    clk_coeff: float = 1.0,
    quant_ratio: int = 0,
) -> torch.Tensor:
    """The per-slot-threshold variant: the fused op with need_filter and
    ``threshold_vec``."""
    return fused_seqpool_cvm(
        rows, key_segments, batch_size, n_slots, use_cvm=use_cvm,
        cvm_offset=cvm_offset, need_filter=True, show_coeff=show_coeff,
        clk_coeff=clk_coeff, threshold_vec=threshold_vec,
        quant_ratio=quant_ratio,
    )


def fused_seqpool_cvm_with_conv(
    rows: torch.Tensor,
    key_segments: torch.Tensor,
    batch_size: int,
    n_slots: int,
    use_cvm: bool = True,
    cvm_offset: int = 3,
    show_filter: bool = False,
    need_filter: bool = False,
    show_coeff: float = 0.2,
    clk_coeff: float = 1.0,
    threshold: float = 0.0,
    quant_ratio: int = 0,
) -> torch.Tensor:
    """The conv-feature variant, rows [show, click, conv, embed...]; CVM
    columns [log(show+1), log(click+1), log(conv+1) - log(click+1)] (the
    conversion rate given a click).  ``show_filter`` drops the show
    column."""
    rows = _prepool(rows, key_segments, n_slots, cvm_offset, need_filter,
                    show_coeff, clk_coeff, threshold, None, 0.0, quant_ratio)
    pooled = seqpool(rows, key_segments, batch_size, n_slots)
    if use_cvm:
        show = pooled[..., 0:1].detach()
        click = pooled[..., 1:2].detach()
        conv = pooled[..., 2:3].detach()
        log_click = torch.log(click + 1.0)
        cols = [torch.log(show + 1.0), log_click,
                torch.log(conv + 1.0) - log_click, pooled[..., cvm_offset:]]
        if show_filter:
            cols = cols[1:]
        out = torch.cat(cols, dim=-1)
    else:
        out = pooled[..., cvm_offset:]
    return out.reshape(batch_size, -1)


def fused_seqpool_cvm_with_pcoc(
    rows: torch.Tensor,
    key_segments: torch.Tensor,
    batch_size: int,
    n_slots: int,
    pclk_num: int,
    use_cvm: bool = True,
    need_filter: bool = False,
    show_coeff: float = 0.2,
    clk_coeff: float = 1.0,
    threshold: float = 0.0,
    quant_ratio: int = 0,
) -> torch.Tensor:
    """The PCOC variant, rows [show, click, d0, d1, q_0..q_{p-1},
    embed...] (max_cvm_offset = 4 + pclk_num).  CVM block, 2 + 2 * pclk_num
    wide: [log(show+1), log(click+1) - log(show+1), log(q_i+1) - log(d0+1)
    for each i, log(q_i+1) - log(d1+1) for each i], then the pooled
    embeds."""
    max_cvm_offset = 4 + pclk_num
    rows = _prepool(rows, key_segments, n_slots, max_cvm_offset, need_filter,
                    show_coeff, clk_coeff, threshold, None, 0.0, quant_ratio)
    pooled = seqpool(rows, key_segments, batch_size, n_slots)
    if not use_cvm:
        return pooled[..., max_cvm_offset:].reshape(batch_size, -1)
    cnt = pooled[..., :max_cvm_offset].detach()
    show, click = cnt[..., 0:1], cnt[..., 1:2]
    d0, d1 = cnt[..., 2:3], cnt[..., 3:4]
    q = cnt[..., 4: 4 + pclk_num]
    log_show = torch.log(show + 1.0)
    log_q = torch.log(q + 1.0)
    out = torch.cat([
        log_show,
        torch.log(click + 1.0) - log_show,
        log_q - torch.log(d0 + 1.0),
        log_q - torch.log(d1 + 1.0),
        pooled[..., max_cvm_offset:],
    ], dim=-1)
    return out.reshape(batch_size, -1)


def fused_seqpool_cvm_extended(
    rows: torch.Tensor,
    key_segments: torch.Tensor,
    batch_size: int,
    n_slots: int,
    expand_dim: int,
    use_cvm: bool = True,
    cvm_offset: int = 2,
) -> tuple:
    """Pool rows that carry a base and an expand embedding and return the
    two blocks apart (the reference's pull_box_extended_sparse): rows [K,
    cvm_offset + emb + expand] -> (base [B, n_slots * pooled_width(...)],
    CVM-transformed with use_cvm; expand [B, n_slots * expand], plain
    pooled values)."""
    if expand_dim <= 0:
        raise ValueError(
            "fused_seqpool_cvm_extended needs expand_dim > 0 "
            "(use fused_seqpool_cvm for plain rows)"
        )
    pooled = seqpool(rows, key_segments, batch_size, n_slots)
    base, expand = pooled[..., :-expand_dim], pooled[..., -expand_dim:]
    if use_cvm:
        base = _cvm_transform(base, cvm_offset)
    else:
        base = base[..., cvm_offset:]
    return base.reshape(batch_size, -1), expand.reshape(batch_size, -1)
