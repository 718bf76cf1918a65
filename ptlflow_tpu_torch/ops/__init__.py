"""Tensor ops of the PyTorch port, NCHW."""

from .correlation import (CorrBlock, all_pairs_correlation,  # noqa: F401
                          build_corr_pyramid, coords_grid,
                          corr_pyramid_lookup,
                          corr_pyramid_lookup_backward_plain,
                          corr_pyramid_lookup_plain, local_correlation,
                          make_corr_lookup, pool_volume_pyramid)
from .deform_conv import DeformConv2d, deform_conv2d  # noqa: F401
from .grid_sample import (bilinear_coverage,  # noqa: F401
                          bilinear_sampler, interpolate, interpolate_bicubic)
from .resize import InputPadder, InputScaler  # noqa: F401
from .upsample import (convex_upsample, convex_upsample_data,  # noqa: F401
                       upflow)
from .warp import (backward_warp, fb_check,  # noqa: F401
                   forward_interpolate, softsplat_average)
