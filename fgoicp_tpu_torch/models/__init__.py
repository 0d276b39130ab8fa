from .goicp import GoICP, register
from .icp import icp_batched, icp_register

FastGoICP = GoICP

__all__ = ["FastGoICP", "GoICP", "icp_batched", "icp_register", "register"]
