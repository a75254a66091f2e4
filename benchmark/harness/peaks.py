"""Published peaks of the cards the benchmark knows, by the name that
``torch.cuda.get_device_name()`` gives.  A card not listed has no roofline
or peak share: the readers of those metrics then return nothing."""

# NVIDIA H100 SXM data sheet: dense float32 outside the tensor cores and HBM3
# bandwidth, at the full power limit of 700 W
H100_SXM = {"fp32_flops": 67e12, "hbm_bytes_per_s": 3.35e12,
            "source": "NVIDIA H100 SXM data sheet, 700 W"}

PEAKS = {
    "NVIDIA H100 80GB HBM3": H100_SXM,
}


def peak_of(kind):
    """The peaks of the card named ``kind``, or None."""
    return PEAKS.get(kind)
