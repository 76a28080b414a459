"""Tiny model builders shared by the test suites and the chip smoke
script (counterpart of ``paddle_tpu/testing/models.py``)."""


def save_mlp(dirname, in_dim=6, hidden=16, depth=1, classes=5, seed=7):
    """Build a small fc->softmax net and save it through
    save_inference_model: row-independent by construction, the same
    program and parameter names as the JAX package's builder. Builds under
    fresh name and scope guards, so the caller's default programs and
    global scope are untouched, and initialises and saves on the CPU; the
    saved directory may then be served on the card. Returns ``dirname``."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.utils import unique_name

    with unique_name.guard(), pt.scope_guard(pt.Scope()):
        main, startup = pt.Program(), pt.Program()
        main.random_seed = startup.random_seed = seed
        with pt.program_guard(main, startup):
            x = pt.layers.data(name="x", shape=[in_dim], dtype="float32")
            h = x
            for _ in range(depth):
                h = pt.layers.fc(input=h, size=hidden, act="relu")
            prob = pt.layers.softmax(pt.layers.fc(input=h, size=classes))
        exe = pt.Executor(pt.CPUPlace())
        exe.run(startup)
        pt.io.save_inference_model(dirname, ["x"], [prob], exe,
                                   main_program=main)
    return dirname
