from crnn_tpu_torch.uq.svgd import (SVGDConfig, make_svgd_step,  # noqa: F401
                                    rbf_kernel, svgd_step)
