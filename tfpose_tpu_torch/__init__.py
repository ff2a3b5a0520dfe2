"""PyTorch / CUDA port of ``tfpose_tpu`` for NVIDIA Hopper cards.

The package mirrors ``tfpose_tpu`` module by module and imports nothing
of it (nor jax, flax, msgpack or cv2): torch, numpy and scipy only. The
three decode kernels on the main path are hand-written CUDA under
``csrc/``, built with ``nvcc`` at first use; every kernel wrapper runs
its plain PyTorch version on CPU tensors.
"""

__version__ = "0.1.0"


def infer(image, model="mobilenet_thin", resize="0x0", resize_out_ratio=4.0,
          device=None):
    """One-shot convenience API (reference ``tf_pose.runner.infer``);
    see :func:`tfpose_tpu_torch.runner.infer`."""
    from tfpose_tpu_torch.runner import infer as _infer
    return _infer(image, model=model, resize=resize,
                  resize_out_ratio=resize_out_ratio, device=device)
