"""Hand-written CUDA kernels of the port and their plain PyTorch versions
(kernels/build.py builds csrc/*.cu; see each module's docstring)."""


def launch_counts() -> dict:
    """Each kernel wrapper's count of launches so far by kernel tier, keyed
    "<kernel>/<tier>" (every key present; 0 on the CPU, where the wrappers
    run their plain versions)."""
    from emap_tpu_torch.kernels import mlp_query, mlp_train

    return {f"{name}/{tier}": n for name, fn in (
        ("mlp_value_and_grad", mlp_query.value_and_grad),
        ("mlp_train_bwd", mlp_train.train_bwd),
        ("mlp_value", mlp_query.value)) for tier, n in fn.tier_launches.items()}
