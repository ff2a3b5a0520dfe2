"""The port's hand-written CUDA kernels, each behind a wrapper that
counts its launches in its ``launches`` attribute."""


def wrappers():
    """The six kernels' wrappers, by name."""
    from tfpose_tpu_torch.ops.assemble import assemble_dense
    from tfpose_tpu_torch.ops.kernels.bias_prelu import bias_prelu
    from tfpose_tpu_torch.ops.kernels.paf_score import score_candidates_raw
    from tfpose_tpu_torch.ops.kernels.smooth_nms import (
        smooth_nms, smooth_nms_topk, smooth_nms_topk_raw)

    return {"smooth_nms_topk_raw": smooth_nms_topk_raw,
            "smooth_nms": smooth_nms,
            "score_candidates_raw": score_candidates_raw,
            "smooth_nms_topk": smooth_nms_topk,
            "assemble_dense": assemble_dense,
            "bias_prelu": bias_prelu}
