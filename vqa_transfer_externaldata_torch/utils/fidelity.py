"""Checkpoint-fidelity oracle: an independent straight-line numpy
reimplementation, in float64, of the whole reference-convention VQA forward
(``model.fidelity_mode``), and a logit-level comparison of two forwards.

The port's own copy of the JAX package's ``utils/fidelity.py``
(``reference_forward_numpy``, ``logits_agree``): it imports neither torch
nor JAX, so it runs wherever the port does, on the machine with the card
too. Its parameters are keyed by the port's ``state_dict`` names
(``gru.gates_kernel``, ``att_q.weight`` [out, in], ...), as numpy arrays
or anything ``np.asarray`` takes.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping, Tuple

import numpy as np


def _f64(params: Mapping[str, Any], key: str) -> np.ndarray:
    value = params[key]
    if hasattr(value, "detach"):  # a tensor: read its values on the host
        value = value.detach().cpu().double().numpy()
    return np.asarray(value, np.float64)


def reference_forward_numpy(params: Mapping[str, Any], features: np.ndarray,
                            q_ids: np.ndarray) -> np.ndarray:
    """Logits [B, num_answers] float64 of the fidelity-mode forward:
    GloVe embedding lookup -> TF1-GRUCell question encoder (packed [x, h]
    kernels, the reset gate on h before the candidate product, padded steps
    carry the state) -> single-glimpse attention over the L2-normalized
    grid in the scale-after-matmul convention -> gated-tanh fusion ->
    cosine answer-embedding classifier. ``params``: the model's
    ``state_dict`` (dense layers' ``weight`` [out, in]); ``features``
    [B, N, C] the gathered grid; ``q_ids`` [B, T] int (<pad> = 0)."""
    f64 = np.float64

    def p(key):
        return _f64(params, key)

    def sig(a):
        return 1.0 / (1.0 + np.exp(-a))

    def l2n(a):  # ops/layers.l2_normalize: a / sqrt(sum a^2 + eps)
        return a / np.sqrt(np.sum(a * a, -1, keepdims=True) + 1e-12)

    def dense(x, name):
        return x @ p(f"{name}.weight").T + p(f"{name}.bias")

    ids = np.asarray(q_ids)
    x = p("word_emb.embedding")[ids]
    mask = (ids != 0).astype(f64)
    wg, bg = p("gru.gates_kernel"), p("gru.gates_bias")  # [D+H, 2H]
    wc, bc = p("gru.candidate_kernel"), p("gru.candidate_bias")  # [D+H, H]
    B, T, _ = x.shape
    H = wc.shape[1]
    h = np.zeros((B, H), f64)
    for t in range(T):
        xt = x[:, t]
        gates = np.concatenate([xt, h], -1) @ wg + bg
        r, z = sig(gates[:, :H]), sig(gates[:, H:])
        c = np.tanh(np.concatenate([xt, r * h], -1) @ wc + bc)
        h_new = z * h + (1.0 - z) * c
        m = mask[:, t][:, None]
        h = m * h_new + (1.0 - m) * h
    q = h

    # z_n = (v_n @ Wv) * r_n + qh; s_n = relu(z_n) . ws; alpha = softmax;
    # v_att = sum_n (alpha_n * r_n) v_n
    v = np.asarray(features, f64)  # [B, N, C]
    qh = dense(q, "att_q")
    r_n = 1.0 / np.sqrt(np.sum(v * v, -1) + 1e-12)  # [B, N]
    Bv, Nv, Cv = v.shape
    vw = (v.reshape(Bv * Nv, Cv) @ p("att_wv")).reshape(Bv, Nv, -1)
    z_att = vw * r_n[:, :, None] + qh[:, None, :]
    s = np.maximum(z_att, 0.0) @ p("att_ws")  # [B, N]
    s = s - s.max(-1, keepdims=True)
    alpha = np.exp(s)
    alpha = alpha / alpha.sum(-1, keepdims=True)
    v_att = np.einsum("bn,bnc->bc", alpha * r_n, v)

    def gated(inp, name):
        return np.tanh(dense(inp, f"{name}.w")) * sig(dense(inp, f"{name}.g"))

    fused = gated(q, "fuse_q") * gated(v_att, "fuse_v")
    zz = dense(fused, "ans_proj")
    e = l2n(p("answer_embedding"))
    logits = l2n(zz) @ e.T
    return logits * float(p("logit_scale")) + p("logit_bias")


def logits_agree(apply_a: Callable, apply_b: Callable, batch: Any, *,
                 atol: float = 1e-4, rtol: float = 1e-3
                 ) -> Tuple[bool, float]:
    """Run two forwards on the same batch: (agree within ``atol`` and
    ``rtol``?, their largest absolute deviation). ``apply_*`` take the
    batch and return logits (numpy arrays or tensors on any device)."""
    la = _f64({"x": apply_a(batch)}, "x")
    lb = _f64({"x": apply_b(batch)}, "x")
    max_abs = float(np.abs(la - lb).max())
    return bool(np.allclose(la, lb, atol=atol, rtol=rtol)), max_abs
