"""The train step's share of the card's f32 peak: FLOPs per training
image (``lib/costs.py``) times the images of the traced steps, over the
window's length at 67 TFLOP/s (f32 without TF32, as the configuration
computes). Layer: train step."""


def read(obs):
    if "images" not in obs or "flops_per_image" not in obs:
        return None
    return 100.0 * obs["images"] * obs["flops_per_image"] / (
        obs["window"].seconds * obs["peak_flops"])
