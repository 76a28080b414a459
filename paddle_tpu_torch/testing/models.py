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


# ---------------------------------------------------------------------------
# Programs built from either package's layers: ``fl`` is the framework
# module (``paddle_tpu_torch``, or a package with the same layers DSL), so
# one builder gives the programs that are compared byte for byte.
# ---------------------------------------------------------------------------

def crnn_ctc(fl, image=(1, 48, 512), filters=(16, 32, 64, 128), hidden=200,
             classes=95, max_label=16, lr=1e-3, momentum=0.9, l2=4e-4,
             seed=90):
    """The CRNN-CTC text recognizer of Fluid's ocr_recognition model
    (crnn_ctc_model.py): per filter width a group of two 3x3 conv +
    batch_norm + relu ending in a 2x2 max pool, ``im2sequence`` with a
    filter as tall as the feature map (one step per column), an fc to
    3 x ``hidden`` then a forward and a reverse ``dynamic_gru`` (relu
    candidates), an fc over both to ``classes`` + 1 (the last id is the
    blank), ``warpctc`` normalised by time, Momentum with L2 decay. The
    test program greedy-decodes (``ctc_greedy_decoder``) and measures the
    ``edit_distance`` of each decoded row to its label, unnormalised.
    Feeds: ``pixel`` [B, *image] float32, ``label`` [B, max_label] and
    ``label_length`` [B] int64."""
    L = fl.layers
    main, startup = fl.Program(), fl.Program()
    main.random_seed = startup.random_seed = seed
    with fl.program_guard(main, startup):
        pixel = L.data(name="pixel", shape=list(image), dtype="float32")
        label = L.data(name="label", shape=[max_label], dtype="int64")
        label_len = L.data(name="label_length", shape=[], dtype="int64")
        x = pixel
        for f in filters:
            x = fl.nets.img_conv_group(
                input=x, conv_num_filter=[f, f], pool_size=2,
                conv_padding=1, conv_filter_size=3, conv_act="relu",
                conv_with_batchnorm=True, pool_stride=2, pool_type="max")
        scale = 2 ** len(filters)
        h, w = image[1] // scale, image[2] // scale
        seq = L.im2sequence(x, filter_size=[h, 1], stride=[1, 1])
        seq = L.reshape(seq, [-1, w, filters[-1] * h])
        fc_f = L.fc(seq, size=3 * hidden, num_flatten_dims=2, bias_attr=False)
        fc_b = L.fc(seq, size=3 * hidden, num_flatten_dims=2, bias_attr=False)
        fwd = L.dynamic_gru(fc_f, size=hidden, candidate_activation="relu")
        bwd = L.dynamic_gru(fc_b, size=hidden, is_reverse=True,
                            candidate_activation="relu")
        logits = L.fc([fwd, bwd], size=classes + 1, num_flatten_dims=2)
        cost = L.warpctc(logits, label, blank=classes, norm_by_times=True,
                         label_length=label_len)
        loss = L.mean(cost)
        decoded, decoded_len = L.ctc_greedy_decoder(logits, blank=classes)
        dist, _ = L.edit_distance(decoded, label, normalized=False,
                                  input_length=decoded_len,
                                  label_length=label_len)
        test = main.clone(for_test=True)
        fl.optimizer.Momentum(
            learning_rate=lr, momentum=momentum,
            regularization=fl.regularizer.L2Decay(l2)).minimize(loss)
    return {"main": main, "startup": startup, "test": test, "loss": loss,
            "logits": logits, "decoded": decoded,
            "decoded_length": decoded_len, "distance": dist,
            "feeds": ["pixel", "label", "label_length"],
            "config": {"image": tuple(image), "classes": classes,
                       "max_label": max_label, "steps": w}}


def crnn_batch(batch, image, classes, max_label, seed):
    """Seeded CRNN feeds: uniform images, labels of 1..max_label ids in
    [0, classes), zeros after each label's length."""
    import numpy as np
    rng = np.random.RandomState(seed)
    length = rng.randint(1, max_label + 1, size=batch).astype(np.int64)
    label = rng.randint(0, classes, size=(batch, max_label)).astype(np.int64)
    label[np.arange(max_label)[None, :] >= length[:, None]] = 0
    return {"pixel": rng.rand(batch, *image).astype(np.float32),
            "label": label, "label_length": length}


def switch_piecewise_lr(fl, boundaries, values):
    """Fluid 1.2's piecewise_decay written with ``layers.Switch``: a
    persistable learning rate assigned ``values[i]`` in the first case
    whose ``step < boundaries[i]`` holds, ``values[-1]`` by default, over
    the global step counter."""
    L = fl.layers
    step = L.learning_rate_scheduler._decay_step_counter()
    lr = L.create_global_var(shape=[1], value=0.0, dtype="float32",
                             persistable=True, name="learning_rate")
    with L.Switch() as switch:
        for b, v in zip(boundaries, values):
            bound = L.fill_constant([1], "float32", float(b))
            value = L.fill_constant([1], "float32", float(v))
            with switch.case(L.less_than(step, bound)):
                L.assign(value, lr)
        last = L.fill_constant([1], "float32", float(values[-1]))
        with switch.default():
            L.assign(last, lr)
    return lr, step


def if_else_mnist(fl, hidden=100, classes=10, in_dim=784, momentum=0.9,
                  boundaries=(3, 6, 9), values=(1e-2, 5e-3, 2e-3, 1e-3),
                  seed=91):
    """Fluid's test_mnist_if_else_op.py: rows routed by ``label < 5``
    through ``layers.IfElse``, each branch an fc ``hidden`` tanh and an fc
    softmax, then cross-entropy; Momentum driven by
    ``switch_piecewise_lr``. Feeds: ``img`` [B, in_dim] float32, ``label``
    [B, 1] int64."""
    L = fl.layers
    main, startup = fl.Program(), fl.Program()
    main.random_seed = startup.random_seed = seed
    with fl.program_guard(main, startup):
        img = L.data(name="img", shape=[in_dim], dtype="float32")
        label = L.data(name="label", shape=[1], dtype="int64")
        limit = L.fill_constant([1], "int64", 5)
        cond = L.less_than(label, limit)
        ie = L.IfElse(cond)
        with ie.true_block():
            h = L.fc(ie.input(img), size=hidden, act="tanh")
            ie.output(L.fc(h, size=classes, act="softmax"))
        with ie.false_block():
            h = L.fc(ie.input(img), size=hidden, act="tanh")
            ie.output(L.fc(h, size=classes, act="softmax"))
        prob, = ie()
        loss = L.mean(L.cross_entropy(prob, label))
        lr, step = switch_piecewise_lr(fl, boundaries, values)
        fl.optimizer.Momentum(learning_rate=lr,
                              momentum=momentum).minimize(loss)
    branches = [op for op in main.global_block().ops if op.type == "if_else"]
    return {"main": main, "startup": startup, "loss": loss, "prob": prob,
            "cond": cond, "lr": lr, "step": step,
            "true_out": branches[0].input("TrueOut")[0],
            "false_out": branches[0].input("FalseOut")[0],
            "boundaries": list(boundaries), "values": list(values)}


def text_cnn(fl, dict_size=5000, emb_dim=32, hid_dim=32, max_len=64,
             seed=92):
    """A text CNN over padded [B, max_len] ids: an embedding, two
    ``sequence_conv`` branches (filter 3 and 4, relu, the pattern
    seqconv_eltadd_relu_fuse_pass rewrites) each sqrt-pooled over the
    length, an fc softmax over both. Returns the inference program (its
    ``predict``) with its startup."""
    L = fl.layers
    main, startup = fl.Program(), fl.Program()
    main.random_seed = startup.random_seed = seed
    with fl.program_guard(main, startup):
        words = L.data(name="words", shape=[max_len, 1], dtype="int64")
        length = L.data(name="length", shape=[], dtype="int32")
        emb = L.embedding(words, size=[dict_size, emb_dim])
        pools = []
        for width in (3, 4):
            conv = L.sequence_conv(emb, num_filters=hid_dim,
                                   filter_size=width, act="relu",
                                   length=length)
            pools.append(L.sequence_pool(conv, "sqrt", length=length))
        predict = L.fc(pools, size=2, act="softmax")
    return {"main": main, "startup": startup, "predict": predict,
            "feeds": ["words", "length"]}


def conditional_block_program(fl, width=3):
    """A hand-built ``conditional_block``, as a program loaded from
    elsewhere holds it (no layer of either package emits the op): out =
    3 * x + 1 where sum(x) < 0, else out keeps its prior value 0.5; the
    sub-block, ``__in_names__`` and ``__out_names__`` set by hand. Feed
    ``x`` [width] float32; returns (program, out variable)."""
    L = fl.layers
    main = fl.Program()
    with fl.program_guard(main, fl.Program()):
        x = L.data(name="x", shape=[width], dtype="float32",
                   append_batch_size=False)
        zero = L.fill_constant([1], "float32", 0.0)
        cond = L.less_than(L.reduce_sum(x, keep_dim=True), zero)
        out = L.fill_constant([width], "float32", 0.5)
        parent = main.global_block()
        sub = main._create_block(parent_idx=parent.idx)
        t = sub.create_var(name="cb_tmp", dtype="float32")
        sub.append_op(type="scale", inputs={"X": [x.name]},
                      outputs={"Out": [t.name]},
                      attrs={"scale": 3.0, "bias": 1.0,
                             "bias_after_scale": True})
        sub.append_op(type="assign", inputs={"X": [t.name]},
                      outputs={"Out": [out.name]})
        main._rollback()
        parent.append_op(
            type="conditional_block",
            inputs={"Cond": [cond.name], "Input": [x.name],
                    "PriorOut": [out.name]},
            outputs={"Out": [out.name]},
            attrs={"sub_block": sub.idx, "__in_names__": [x.name],
                   "__out_names__": [out.name]})
    return main, out
