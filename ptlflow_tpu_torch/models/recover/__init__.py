from .recover import (FlowAnything, ReCoVEr, flow_anything,  # noqa: F401
                      recover_cx, recover_mn, recover_rn)
