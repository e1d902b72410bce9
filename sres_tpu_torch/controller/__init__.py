from sres_tpu_torch.controller.workflow import WorkflowController  # noqa: F401
