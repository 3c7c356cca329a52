"""Model FLOP utilization of the traced window: three forward passes of
the model for each valid training sample and one for each eval sample,
counted from the model's shapes (``bench.measure.forward_flops``), over
the window's seconds and the card's peak in the precision the timed
path computes in, read from ``torch.backends`` as the window starts."""

#: NVIDIA H100 SXM, dense: float32 outside the tensor cores, TF32, bf16
PEAK_FLOPS = {"f32": 67e12, "tf32": 495e12, "bf16": 989e12}


def read(rec):
    if not rec.get("window_s") or not rec.get("train_samples"):
        return None
    flops = rec["fwd_flops"] * (3 * rec["train_samples"]
                                + rec["eval_samples"])
    return 100.0 * flops / rec["window_s"] / PEAK_FLOPS[rec["precision"]]
