"""The yardstick's arithmetic: operations and bytes from shapes, and the
card's published peaks.

``train_step_flops``, ``attention_bound_ms``, ``bwd_bound_ms`` and
``_bound`` are copies of ``chip_smoke.py``'s (kept here so that a change
to the program cannot move the yardstick). The peaks are chosen by the
card's name, not fixed for one part.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Peaks:
    """Published dense peaks of one card (NVIDIA's data sheets), at the
    card's full power limit."""
    bf16_flops: float
    f32_flops: float
    bytes_per_s: float


# By a substring of ``torch.cuda.get_device_name()``, most specific first.
PEAKS = (
    ("H100 PCIe", Peaks(756e12, 51e12, 2.0e12)),
    ("H100 NVL", Peaks(835e12, 60e12, 3.9e12)),
    ("H100", Peaks(989e12, 67e12, 3.35e12)),          # SXM, 80GB HBM3
)


def peaks_for(device_name: str) -> Peaks | None:
    """The peaks of the card named ``device_name``; None for a card the
    table does not know (its roofline shares are then not reported)."""
    for key, peaks in PEAKS:
        if key in device_name:
            return peaks
    return None


def train_step_flops(model: dict, batch: int) -> float:
    """Analytic matmul FLOPs of one train step (forward + backward = 3x
    the forward): the dense products and the causal half of attention's
    score and context products, on the seq_len - 1 positions the loss
    trains. ``model`` holds the burn-in config's sizes."""
    s = model["seq_len"] - 1
    d, ff, v = model["d_model"], model["d_ff"], model["vocab"]
    per_token_layer = 2 * d * 3 * d + 2 * d * d + 2 * d * ff + 2 * ff * d
    per_layer_attn = 2 * batch * s * s * d
    fwd = (batch * s * (model["n_layers"] * per_token_layer + 2 * d * v)
           + model["n_layers"] * per_layer_attn)
    return 3.0 * fwd


def _bound(nbytes: int, flops: int, dtype: str, peaks: Peaks) -> tuple:
    """(least ms, what bounds it, the operations) for moving ``nbytes``
    and doing ``flops`` at the card's published peaks."""
    peak = peaks.bf16_flops if dtype == "bfloat16" else peaks.f32_flops
    t_bytes, t_ops = nbytes / peaks.bytes_per_s, flops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", flops)


def attention_bound_ms(shape, dtype: str, causal: bool,
                       peaks: Peaks) -> tuple:
    """Least time for one flash forward on these inputs: q, k, v read
    once, o and lse written once, against the causal (or full) products
    QK^T and PV these inputs need."""
    b, s, h, d = shape
    elt = 2 if dtype == "bfloat16" else 4
    nbytes = 4 * b * s * h * d * elt + b * h * s * 4
    pairs = s * (s + 1) // 2 if causal else s * s
    flops = 4 * b * h * pairs * d
    return _bound(nbytes, flops, dtype, peaks)


def bwd_bound_ms(shape, dtype: str, causal: bool, kernel: str,
                 peaks: Peaks, delta_given: bool = False) -> tuple:
    """Least time for one backward kernel on these inputs. dQ reads q, k,
    v, dO and lse and writes dq, and either reads o and writes delta (it
    computes delta) or reads the delta it is given; dK/dV reads q, k, v,
    dO, lse and delta and writes dk and dv: six (or dQ with delta given,
    five) [b, s, h, d] tensors and two f32 [b*h, s] rows each. Against the
    causal (or full) products each needs: S, dP and dS K (dQ); S, dP,
    P^T dO and dS^T Q (dK/dV)."""
    b, s, h, d = shape
    elt = 2 if dtype == "bfloat16" else 4
    tensors = 5 if kernel == "dq" and delta_given else 6
    nbytes = tensors * b * s * h * d * elt + 2 * b * h * s * 4
    pairs = s * (s + 1) // 2 if causal else s * s
    flops = (3 if kernel == "dq" else 4) * 2 * b * h * pairs * d
    return _bound(nbytes, flops, dtype, peaks)
