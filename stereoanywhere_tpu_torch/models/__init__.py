"""The port's networks: StereoAnywhere and Depth-Anything-V2."""
from stereoanywhere_tpu_torch.models.dpt import DepthAnythingV2  # noqa: F401
from stereoanywhere_tpu_torch.models.stereoanywhere import StereoAnywhere  # noqa: F401
