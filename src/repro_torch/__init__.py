"""`repro_torch` — the PyTorch/CUDA port of the barycentric Lagrange
treecode in `repro`.

The layout mirrors `repro` file for file. Host planning (tree, batches,
MAC dual traversal) is NumPy; execution is PyTorch, with hand-written
CUDA kernels for the batch-cluster sum and the modified charges. Entry
points run on the CUDA device unless the caller passes ``device="cpu"``,
where the kernels' plain PyTorch versions run instead.

    from repro_torch.core.api import TreecodeConfig, TreecodeSolver
    plan = TreecodeSolver(TreecodeConfig(theta=0.7, degree=8)).plan(x)
    phi = plan.execute(q)
"""
