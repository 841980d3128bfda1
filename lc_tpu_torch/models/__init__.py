from .ptnet import PtNet, build_model, output_channel_slices
from .layers import default_compute_dtype, set_compute_dtype
