from .videoflow import (VideoFlowBOF, VideoFlowMOF,  # noqa: F401
                        videoflow_bof, videoflow_mof)
