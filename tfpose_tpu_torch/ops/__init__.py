from tfpose_tpu_torch.ops import assemble, decode, gaussian, nms, paf, resize

__all__ = ["assemble", "decode", "gaussian", "nms", "paf", "resize"]
