"""Resource accounting — the paper's C1 (compute, eq. 1) and C2
(communication, eq. 2) meters.

A copy of the reference's ``core/accounting.py`` (numpy only), cut to
what the LeNet and the LM trainers bill (the decoder-only branches of
the transformer FLOP models, dense and MoE).

Bandwidth counts actual payload bytes crossing the client<->server
boundary (activations + labels up, gradients down when applicable).
Sparse payloads (activation-sparsified AdaSplit, Table 6) are counted as
nnz * (value + index) bytes.  Compute uses analytic FLOP models
(matmul-dominated): forward = 2*W*n, backward = 2x forward.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.configs.base import ModelConfig


def array_bytes(shape, dtype_bytes=4, nnz_fraction: Optional[float] = None
                ) -> int:
    n = int(np.prod(shape))
    if nnz_fraction is None:
        return n * dtype_bytes
    nnz = int(n * nnz_fraction)
    return nnz * (dtype_bytes + 4)  # value + int32 index


def split_payload_bytes(acts_shape, batch, *,
                        nnz_fraction: Optional[float] = None,
                        grad_down: bool = False,
                        dtype_bytes: int = 4) -> int:
    """Bytes crossing the split for one selected client in one global
    iteration: activations (sparse when ``nnz_fraction`` is given — the
    billed client's own sparsity) + int32 labels up, activation
    gradients down when the server-grad-to-client ablation is on."""
    up = array_bytes(acts_shape, dtype_bytes, nnz_fraction) \
        + array_bytes((batch,), 4)
    down = array_bytes(acts_shape, dtype_bytes) if grad_down else 0
    return up + down


def batch_payload_bytes(acts_shape, batch, *, count: Optional[int] = None,
                        nnz_fracs=None, grad_down: bool = False,
                        dtype_bytes: int = 4) -> int:
    """Total split-payload bytes over many selection events: exactly the
    sum of :func:`split_payload_bytes` over ``nnz_fracs`` (or ``count``
    dense events), with no Python loop."""
    n = int(np.prod(acts_shape))
    per_dense = batch * 4 + (n * dtype_bytes if grad_down else 0)
    if nnz_fracs is None:
        assert count is not None
        return count * (n * dtype_bytes + per_dense)
    fr = np.asarray(nnz_fracs, np.float64).ravel()
    nnz = (n * fr).astype(np.int64)          # trunc == int(n * f), f >= 0
    return int(np.sum(nnz) * (dtype_bytes + 4) + fr.size * per_dense)


def lenet_flops_per_example(cfg: ModelConfig, part: str = "full") -> float:
    """Forward FLOPs for one example through the conv blocks + FC."""
    from repro_torch.models.lenet import split_index
    s = split_index(cfg)
    hw = cfg.image_size
    cin = 3
    fl_client = fl_server = 0.0
    for i, c in enumerate(cfg.conv_channels):
        f = 2 * hw * hw * 25 * cin * c  # 5x5 conv
        if i < s:
            fl_client += f
        else:
            fl_server += f
        cin = c
        hw //= 2
    flat = max(hw, 1) ** 2 * cfg.conv_channels[-1]
    fl_server += 2 * (flat * 120 + 120 * cfg.d_model
                      + cfg.d_model * cfg.n_classes)
    return {"client": fl_client, "server": fl_server,
            "full": fl_client + fl_server}[part]


def transformer_matmul_params(cfg: ModelConfig, part: str = "full") -> float:
    """Matmul weights touched per token, active experts only (the
    embedding rows are gathered, not multiplied; the LM head is
    server-side).  An encoder-decoder's client holds a share of the
    encoder, taken as half the body, as the reference takes it."""
    full = cfg.active_param_count()
    emb = cfg.padded_vocab() * cfg.d_model
    body = full - 2 * emb if not cfg.is_conv else full
    n = cfg.n_encoder_layers if cfg.is_encoder_decoder else cfg.n_layers
    frac_client = cfg.split_layer / max(n, 1)
    if cfg.is_encoder_decoder:
        frac_client *= 0.5
    cl = body * frac_client
    sv = body - cl + emb  # head matmul is server-side
    return {"client": cl, "server": sv, "full": cl + sv}[part]


def transformer_flops_per_token(cfg: ModelConfig, part: str = "full",
                                seq_len: int = 0) -> float:
    """Forward FLOPs per token: 2 x the matmul weights, plus the attention
    score/value term at ``seq_len``, split by layer ownership."""
    f = 2.0 * transformer_matmul_params(cfg, part)
    if seq_len and not cfg.is_conv:
        n_attn = sum(1 for i in range(cfg.n_layers) if
                     (cfg.n_heads and cfg.is_attn_layer(i)))
        att = 4.0 * seq_len * cfg.n_heads * cfg.head_dim * n_attn
        if part == "client":
            att *= cfg.split_layer / max(cfg.n_layers, 1)
        elif part == "server":
            att *= 1 - cfg.split_layer / max(cfg.n_layers, 1)
        f += att
    return f


@dataclass
class Meter:
    bandwidth_bytes: float = 0.0
    client_flops: float = 0.0
    server_flops: float = 0.0
    # cross-device collective traffic (0 on one device)
    interconnect_bytes: float = 0.0
    # host<->device staging traffic (round-data uploads)
    host_device_bytes: float = 0.0

    def add_payload(self, nbytes: float):
        self.bandwidth_bytes += nbytes

    def add_client_flops(self, f: float):
        self.client_flops += f

    def add_server_flops(self, f: float):
        self.server_flops += f

    def add_interconnect(self, nbytes: float):
        self.interconnect_bytes += nbytes

    def add_host_device(self, nbytes: float):
        self.host_device_bytes += nbytes

    def ingest_round(self, *, acts_shape, batch, n_clients, n_iters,
                     client_flops_per_example, server_flops_per_example,
                     nnz_fracs=None, n_selected=None, grad_down=False,
                     dtype_bytes=4, interconnect_bytes=0.0,
                     host_device_bytes=0.0):
        """Bill a whole round after the rung's one device fetch, with
        totals equal bit for bit to the eager per-event billing (every
        addend is an integer-valued float, so the order does not matter).

        nnz_fracs: optional (n_iters, k) per-selected-client payload nnz
        fractions (activation sparsification on); ``n_selected`` (k) is
        required when it is None.  ``interconnect_bytes`` and
        ``host_device_bytes`` are the round's analytic totals."""
        if nnz_fracs is not None:
            nnz_fracs = np.asarray(nnz_fracs)
            n_selected = nnz_fracs.shape[-1]
        assert n_selected is not None
        fwd_bwd = 3  # fwd + 2x bwd
        self.add_client_flops(fwd_bwd * client_flops_per_example
                              * n_clients * batch * n_iters)
        self.add_payload(batch_payload_bytes(
            acts_shape, batch, count=n_iters * n_selected,
            nnz_fracs=nnz_fracs, grad_down=grad_down,
            dtype_bytes=dtype_bytes))
        self.add_server_flops(fwd_bwd * server_flops_per_example
                              * batch * n_iters * n_selected)
        if interconnect_bytes:
            self.add_interconnect(interconnect_bytes)
        if host_device_bytes:
            self.add_host_device(host_device_bytes)

    def ingest_epoch(self, *, n_rounds, nnz_fracs=None, **round_kw):
        """Bill an epoch of ``n_rounds`` rounds after one fetch: that many
        :meth:`ingest_round` calls (nnz_fracs (n_rounds, n_iters, k) when
        given; every other argument per round).  Returns the cumulative
        summary after each round, for the per-round history records."""
        summaries = []
        for r in range(n_rounds):
            self.ingest_round(
                nnz_fracs=nnz_fracs[r] if nnz_fracs is not None else None,
                **round_kw)
            summaries.append(self.summary())
        return summaries

    @property
    def bandwidth_gb(self) -> float:
        return self.bandwidth_bytes / 1e9

    @property
    def client_tflops(self) -> float:
        return self.client_flops / 1e12

    @property
    def total_tflops(self) -> float:
        return (self.client_flops + self.server_flops) / 1e12

    @property
    def interconnect_gb(self) -> float:
        return self.interconnect_bytes / 1e9

    @property
    def host_device_gb(self) -> float:
        return self.host_device_bytes / 1e9

    def summary(self) -> dict:
        return {
            "bandwidth_gb": self.bandwidth_gb,
            "client_tflops": self.client_tflops,
            "total_tflops": self.total_tflops,
            "interconnect_gb": self.interconnect_gb,
            "host_device_gb": self.host_device_gb,
        }
