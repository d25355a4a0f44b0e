"""Hand-written CUDA kernels of the port and their plain PyTorch versions
(kernels/build.py builds csrc/*.cu; see each module's docstring)."""


def launch_counts() -> dict:
    """Each kernel wrapper's count of launches so far (0 on the CPU, where
    the wrappers run their plain versions)."""
    from emap_tpu_torch.kernels import mlp_query, mlp_train

    return {"mlp_value_and_grad": mlp_query.value_and_grad.launches,
            "mlp_train_bwd": mlp_train.train_bwd.launches,
            "mlp_value": mlp_query.value.launches}
