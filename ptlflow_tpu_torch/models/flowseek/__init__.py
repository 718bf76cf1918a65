from .flowseek import (FlowSeek, create_bases, flowseek_m,  # noqa: F401
                       flowseek_t)
