from sres_tpu_torch.controller.workflow import WorkflowController  # noqa: F401
from sres_tpu_torch.data.inference_io import ResultStructure, TSet  # noqa: F401
from sres_tpu_torch.data.inference_io import srRes  # noqa: F401
