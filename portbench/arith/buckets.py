"""Device activities by kind, from the kernel's name.

Copied from ``pkr_tpu_torch/tools/train_roofline.py``'s ``bucket_of``:
cuDNN's convolutions and cuBLAS's GEMMs share ``xmma``, so convolutions go
by ``implicit_gemm``, ``fprop``, ``dgrad``, ``wgrad``; every activity falls
in some bucket, so the buckets sum to the traced device time."""

BUCKETS = ("convolution", "batchnorm", "layout", "elementwise", "optimizer", "head")


def bucket_of(name: str) -> str:
    n = name.lower()
    if "nchwtonhwc" in n or "nhwctonchw" in n:
        return "layout"
    if "batch_norm" in n or "bn_fw" in n or "bn_bw" in n:
        return "batchnorm"
    if any(k in n for k in ("conv", "implicit_gemm", "fprop", "dgrad", "wgrad")):
        return "convolution"
    if "multi_tensor_apply" in n:
        return "optimizer"
    if any(k in n for k in ("gemm", "gemv", "softmax", "nll_loss", "topk", "sort")):
        return "head"
    return "elementwise"


def buckets(by_name_s: dict) -> dict:
    out = dict.fromkeys(BUCKETS, 0.0)
    for name, s in by_name_s.items():
        out[bucket_of(name)] += s
    return out
