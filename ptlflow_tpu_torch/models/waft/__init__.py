from .waft import (WAFTa1, WAFTa2, waft_dav2_a1, waft_dav2_a2,  # noqa: F401
                   waft_dinov3_a2, waft_twins_a2)
