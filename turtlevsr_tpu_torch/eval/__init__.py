from turtlevsr_tpu_torch.eval.engine import InferenceEngine  # noqa: F401
