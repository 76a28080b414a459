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

# ocr_recognition train.py's ModelAverage windows
CRNN_MIN_AVERAGE_WINDOW = 10000
CRNN_MAX_AVERAGE_WINDOW = 12500


def crnn_ctc(fl, image=(1, 48, 512), filters=(16, 32, 64, 128), hidden=200,
             classes=95, max_label=16, lr=1e-3, momentum=0.9, l2=4e-4,
             seed=90, average_window=None):
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
    ``label_length`` [B] int64. With ``average_window``, a
    ``ModelAverage`` of that rate and train.py's windows follows
    ``minimize`` (``"model_average"``)."""
    L = fl.layers
    main, startup = fl.Program(), fl.Program()
    main.random_seed = startup.random_seed = seed
    model_average = None
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
        if average_window is not None:
            model_average = fl.optimizer.ModelAverage(
                average_window, min_average_window=CRNN_MIN_AVERAGE_WINDOW,
                max_average_window=CRNN_MAX_AVERAGE_WINDOW)
    return {"main": main, "startup": startup, "test": test, "loss": loss,
            "model_average": model_average,
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


def _mobilenet_ssd_net(fl, image, classes, scale):
    """MobileNet v1 and the six-map SSD head of PaddleCV's
    object_detection/mobilenet_ssd.py (``conv_bn``, ``depthwise_separable``,
    ``extra_block``, ``multi_box_head``)."""
    L = fl.layers

    def conv_bn(x, filter_size, num_filters, stride, padding, num_groups=1):
        conv = L.conv2d(
            x, num_filters=num_filters, filter_size=filter_size,
            stride=stride, padding=padding, groups=num_groups,
            use_cudnn=num_groups == 1, bias_attr=False,
            param_attr=fl.ParamAttr(learning_rate=0.1,
                                    initializer=fl.initializer.MSRA()))
        return L.batch_norm(conv, act="relu")

    def depthwise_separable(x, f1, f2, groups, stride):
        x = conv_bn(x, 3, int(f1 * scale), stride, 1,
                    num_groups=int(groups * scale))
        return conv_bn(x, 1, int(f2 * scale), 1, 0)

    def extra_block(x, f1, f2):
        # the source's num_groups=int(1 * scale) is 0 below scale 1
        x = conv_bn(x, 1, int(f1 * scale), 1, 0)
        return conv_bn(x, 3, int(f2 * scale), 2, 1)

    img = L.data(name="image", shape=list(image), dtype="float32")
    x = conv_bn(img, 3, int(32 * scale), 2, 1)
    x = depthwise_separable(x, 32, 64, 32, 1)
    x = depthwise_separable(x, 64, 128, 64, 2)
    x = depthwise_separable(x, 128, 128, 128, 1)
    x = depthwise_separable(x, 128, 256, 128, 2)
    x = depthwise_separable(x, 256, 256, 256, 1)
    x = depthwise_separable(x, 256, 512, 256, 2)
    for _ in range(5):
        x = depthwise_separable(x, 512, 512, 512, 1)
    module11 = x
    x = depthwise_separable(x, 512, 1024, 512, 2)
    module13 = depthwise_separable(x, 1024, 1024, 1024, 1)
    module14 = extra_block(module13, 256, 512)
    module15 = extra_block(module14, 128, 256)
    module16 = extra_block(module15, 128, 256)
    module17 = extra_block(module16, 64, 128)
    locs, confs, box, box_var = L.multi_box_head(
        inputs=[module11, module13, module14, module15, module16, module17],
        image=img, num_classes=classes, min_ratio=20, max_ratio=90,
        min_sizes=[60.0, 105.0, 150.0, 195.0, 240.0, 285.0],
        max_sizes=[[], 150.0, 195.0, 240.0, 285.0, 300.0],
        aspect_ratios=[[2.], [2., 3.], [2., 3.], [2., 3.], [2., 3.],
                       [2., 3.]],
        base_size=image[2], offset=0.5, flip=True)
    return img, locs, confs, box, box_var


# PaddleCV object_detection/train.py (Pascal VOC): the base rate, batch,
# training-set size, the piecewise schedule in epochs and the L2 decay;
# eval.py and detection_output's defaults: the NMS settings
SSD_LR = 0.001
SSD_BATCH_SIZE = 64
SSD_TRAIN_IMAGES = 16551
SSD_LR_EPOCHS = (40, 60, 80, 100)
SSD_LR_DECAY = (1, 0.5, 0.25, 0.1, 0.01)
SSD_L2 = 5e-5
SSD_NMS_THRESHOLD = 0.45
SSD_NMS_TOP_K = 400
SSD_KEEP_TOP_K = 200
DETECTION_SEED = 2024


def mobilenet_ssd(fl, image=(3, 300, 300), classes=21, scale=1.0, gt_pad=50):
    """PaddleCV's MobileNet-SSD on Pascal VOC (object_detection/
    mobilenet_ssd.py, train.py, eval.py): a 300x300 image, 21 classes,
    MobileNet v1 at ``scale``, six prior maps (19, 10, 5, 3, 2, 1 cells at
    300: 1917 priors). The train program sums ``ssd_loss`` and takes
    RMSProp with L2Decay and the piecewise rate of train.py (boundaries at
    ``SSD_LR_EPOCHS`` x ``SSD_TRAIN_IMAGES // SSD_BATCH_SIZE`` steps). The
    test program decodes with ``detection_output`` and measures
    ``detection_map`` (11point) against the padded gt; ``detections`` is
    what an inference model serves. As in train.py, each program is built
    under its own ``unique_name.guard()``, so both name the parameters
    alike, and the test program is cloned ``for_test`` (batch_norm on its
    running statistics).

    Feeds: ``image`` [B, *image] float32, ``gt_box`` [B, gt_pad, 4]
    float32 (x1, y1, x2, y2 in 0-1; zero rows pad) and ``gt_label``
    [B, gt_pad] int32 (1..classes-1; -1 pads)."""
    L = fl.layers

    def gt_feeds():
        gt_box = L.data(name="gt_box", shape=[gt_pad, 4], dtype="float32")
        gt_label = L.data(name="gt_label", shape=[gt_pad], dtype="int32")
        return gt_box, gt_label

    main, startup = fl.Program(), fl.Program()
    main.random_seed = startup.random_seed = DETECTION_SEED
    with fl.unique_name.guard(), fl.program_guard(main, startup):
        _, locs, confs, box, box_var = _mobilenet_ssd_net(fl, image, classes,
                                                          scale)
        gt_box, gt_label = gt_feeds()
        loss = L.reduce_sum(L.ssd_loss(locs, confs, gt_box, gt_label, box,
                                       box_var))
        iters = SSD_TRAIN_IMAGES // SSD_BATCH_SIZE
        rate = L.learning_rate_scheduler.piecewise_decay(
            [e * iters for e in SSD_LR_EPOCHS],
            [d * SSD_LR for d in SSD_LR_DECAY])
        fl.optimizer.RMSProp(
            learning_rate=rate,
            regularization=fl.regularizer.L2Decay(SSD_L2)).minimize(loss)

    test, test_startup = fl.Program(), fl.Program()
    with fl.unique_name.guard(), fl.program_guard(test, test_startup):
        _, locs, confs, box, box_var = _mobilenet_ssd_net(fl, image, classes,
                                                          scale)
        gt_box, gt_label = gt_feeds()
        nmsed = L.detection_output(locs, confs, box, box_var,
                                   nms_threshold=SSD_NMS_THRESHOLD,
                                   nms_top_k=SSD_NMS_TOP_K,
                                   keep_top_k=SSD_KEEP_TOP_K)
        label = L.concat([L.cast(L.unsqueeze(gt_label, axes=[2]), "float32"),
                          gt_box], axis=2)
        m_ap = L.detection_map(nmsed, label, class_num=classes,
                               overlap_threshold=0.5, ap_version="11point")
    test = test.clone(for_test=True)
    return {"main": main, "startup": startup, "test": test, "loss": loss,
            "detections": nmsed, "map": m_ap,
            "feeds": ["image", "gt_box", "gt_label"],
            "config": {"image": tuple(image), "classes": classes,
                       "gt_pad": gt_pad}}


def detection_batch(batch, image, classes, gt_pad, seed, max_boxes=8):
    """Seeded detection feeds: uniform images, 1..max_boxes gt boxes an
    image (corners in 0-1, each side at least 0.05) with labels in
    1..classes-1, then zero boxes and label -1 to ``gt_pad`` rows."""
    import numpy as np
    rng = np.random.RandomState(seed)
    gt_box = np.zeros((batch, gt_pad, 4), np.float32)
    gt_label = np.full((batch, gt_pad), -1, np.int32)
    for b in range(batch):
        k = rng.randint(1, min(max_boxes, gt_pad) + 1)
        lo = rng.uniform(0.0, 0.7, size=(k, 2))
        size = rng.uniform(0.05, 0.3, size=(k, 2))
        gt_box[b, :k] = np.concatenate([lo, np.minimum(lo + size, 1.0)], 1)
        gt_label[b, :k] = rng.randint(1, classes, size=k)
    return {"image": rng.rand(batch, *image).astype(np.float32),
            "gt_box": gt_box, "gt_label": gt_label}


YOLOV3_ANCHORS = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119, 116, 90,
                  156, 198, 373, 326]
YOLOV3_MASKS = [[6, 7, 8], [3, 4, 5], [0, 1, 2]]
# PaddleCV yolov3/config.py: the rate, momentum and weight decay, the
# loss's ignore_thresh, and the decode's valid_thresh and nms_thresh
YOLOV3_LR = 0.001
YOLOV3_MOMENTUM = 0.9
YOLOV3_L2 = 5e-4
YOLOV3_IGNORE_THRESH = 0.7
YOLOV3_CONF_THRESH = 0.005
YOLOV3_NMS_THRESHOLD = 0.45


def yolov3_head(fl, image=608, classes=80, channels=(1024, 512, 256),
                gt_pad=50, nms_top_k=1000, keep_top_k=100):
    """The three detection scales of PaddleCV's YOLOv3 (yolov3/models/
    yolov3.py) on backbone features fed in (``c5``, ``c4``, ``c3`` at
    strides 32, 16, 8: 19, 38 and 76 cells at 608): each scale's
    ``yolo_detection_block`` (five 1x1/3x3 conv + batch_norm + leaky
    relu, then the tip), a 1x1 conv to 3 x (5 + classes), the route
    upsampled x2 by ``resize_nearest`` and concatenated into the next
    scale; ``yolov3_loss`` at each scale (the 9 COCO anchors, masks
    [6,7,8], [3,4,5], [0,1,2]) summed and meaned, Momentum with L2Decay.
    The test program decodes every scale with ``yolo_box`` and keeps
    ``multiclass_nms``'s rows over all classes.

    Feeds: ``c5``/``c4``/``c3`` float32, ``gt_box`` [B, gt_pad, 4] (x, y,
    w, h in 0-1; zero rows pad), ``gt_label`` [B, gt_pad] int32 and
    ``img_size`` [B, 2] int32 (h, w)."""
    L = fl.layers
    strides = (32, 16, 8)

    def conv_bn(x, ch, size, stride=1):
        conv = L.conv2d(
            x, num_filters=ch, filter_size=size, stride=stride,
            padding=(size - 1) // 2, bias_attr=False,
            param_attr=fl.ParamAttr(
                initializer=fl.initializer.NormalInitializer(0.0, 0.02)))
        return L.leaky_relu(L.batch_norm(conv), alpha=0.1)

    def detection_block(x, ch):
        for _ in range(2):
            x = conv_bn(x, ch, 1)
            x = conv_bn(x, ch * 2, 3)
        route = conv_bn(x, ch, 1)
        return route, conv_bn(route, ch * 2, 3)

    def net():
        feats = [L.data(name=n, shape=[c, image // s, image // s],
                        dtype="float32")
                 for n, c, s in zip(("c5", "c4", "c3"), channels, strides)]
        outputs, route = [], None
        for i, x in enumerate(feats):
            if i > 0:
                x = L.concat([route, x], axis=1)
            route, tip = detection_block(x, 512 // (2 ** i))
            outputs.append(L.conv2d(
                tip, num_filters=len(YOLOV3_MASKS[i]) * (classes + 5),
                filter_size=1,
                param_attr=fl.ParamAttr(
                    initializer=fl.initializer.NormalInitializer(0.0, 0.02))))
            if i < len(feats) - 1:
                route = L.resize_nearest(conv_bn(route, 256 // (2 ** i), 1),
                                         scale=2)
        return outputs

    main, startup = fl.Program(), fl.Program()
    main.random_seed = startup.random_seed = DETECTION_SEED
    with fl.unique_name.guard(), fl.program_guard(main, startup):
        outputs = net()
        gt_box = L.data(name="gt_box", shape=[gt_pad, 4], dtype="float32")
        gt_label = L.data(name="gt_label", shape=[gt_pad], dtype="int32")
        losses = [L.reduce_mean(L.yolov3_loss(
            out, gt_box, gt_label, anchors=YOLOV3_ANCHORS,
            anchor_mask=YOLOV3_MASKS[i], class_num=classes,
            ignore_thresh=YOLOV3_IGNORE_THRESH, downsample_ratio=strides[i]))
            for i, out in enumerate(outputs)]
        loss = L.elementwise_add(L.elementwise_add(losses[0], losses[1]),
                                 losses[2])
        fl.optimizer.Momentum(
            learning_rate=YOLOV3_LR, momentum=YOLOV3_MOMENTUM,
            regularization=fl.regularizer.L2Decay(YOLOV3_L2)).minimize(loss)

    test, test_startup = fl.Program(), fl.Program()
    with fl.unique_name.guard(), fl.program_guard(test, test_startup):
        outputs = net()
        img_size = L.data(name="img_size", shape=[2], dtype="int32")
        boxes, scores = [], []
        for i, out in enumerate(outputs):
            anchors = [v for m in YOLOV3_MASKS[i]
                       for v in YOLOV3_ANCHORS[2 * m:2 * m + 2]]
            b, s = L.yolo_box(out, img_size, anchors=anchors,
                              class_num=classes,
                              conf_thresh=YOLOV3_CONF_THRESH,
                              downsample_ratio=strides[i])
            boxes.append(b)
            scores.append(L.transpose(s, perm=[0, 2, 1]))
        nmsed = L.multiclass_nms(
            L.concat(boxes, axis=1), L.concat(scores, axis=2),
            score_threshold=YOLOV3_CONF_THRESH, nms_top_k=nms_top_k,
            keep_top_k=keep_top_k,
            nms_threshold=YOLOV3_NMS_THRESHOLD,
            background_label=-1)
    test = test.clone(for_test=True)
    return {"main": main, "startup": startup, "test": test, "loss": loss,
            "detections": nmsed,
            "feeds": ["c5", "c4", "c3", "gt_box", "gt_label"],
            "config": {"image": image, "classes": classes,
                       "channels": tuple(channels), "gt_pad": gt_pad}}


def yolov3_batch(batch, image, channels, classes, gt_pad, seed,
                 max_boxes=8):
    """Seeded YOLOv3-head feeds: normal backbone features, 1..max_boxes gt
    boxes an image (centre and size in 0-1) with labels in 0..classes-1,
    zero rows and label 0 after them, and the image size."""
    import numpy as np
    rng = np.random.RandomState(seed)
    feeds = {n: rng.randn(batch, c, image // s, image // s).astype(np.float32)
             for n, c, s in zip(("c5", "c4", "c3"), channels, (32, 16, 8))}
    gt_box = np.zeros((batch, gt_pad, 4), np.float32)
    gt_label = np.zeros((batch, gt_pad), np.int32)
    for b in range(batch):
        k = rng.randint(1, min(max_boxes, gt_pad) + 1)
        gt_box[b, :k, :2] = rng.uniform(0.1, 0.9, size=(k, 2))
        gt_box[b, :k, 2:] = rng.uniform(0.02, 0.5, size=(k, 2))
        gt_label[b, :k] = rng.randint(0, classes, size=k)
    feeds.update(gt_box=gt_box, gt_label=gt_label,
                 img_size=np.full((batch, 2), image, np.int32))
    return feeds


# ---------------------------------------------------------------------------
# the general tensor and loss ops on real models: Transformer-base with
# PaddleNLP's label smoothing, word2vec with the nce and hsigmoid heads
# ---------------------------------------------------------------------------

def _transformer_layer(fn, *args, **kwargs):
    """An encoder or decoder layer of either package: the JAX package's
    take explicit attention-bias arguments (None here: the masks are key
    biases), the port's do not."""
    import inspect
    params = inspect.signature(fn).parameters
    for bias in ("attn_bias", "self_attn_bias", "cross_attn_bias"):
        if bias in params:
            kwargs[bias] = None
    return fn(*args, **kwargs)


# PaddlePaddle/models fluid/PaddleNLP/neural_machine_translation/
# transformer config.py: label_smooth_eps
LABEL_SMOOTH_EPS = 0.1


def transformer_label_smooth(fl, src_vocab=10000, tgt_vocab=10000,
                             max_len=64, n_layer=6, n_head=8, d_model=512,
                             d_inner_hid=2048, dropout_rate=0.0,
                             warmup_steps=8000):
    """The Transformer of PaddlePaddle/models' fluid/PaddleNLP
    neural_machine_translation/transformer (model.py, with config.py's
    ``label_smooth_eps``, ``LABEL_SMOOTH_EPS``): the encoder and decoder of
    ``fl.models.transformer`` (every attention a flash op, length key
    biases), then its loss: ``label_smooth(one_hot(lbl_word,
    depth=tgt_vocab))`` against the logits by
    ``softmax_with_cross_entropy(soft_label=True)``, weighted by the
    ``trg_len`` token mask and divided by the token count, as
    ``transformer.build``'s is; Adam (0.9, 0.98, 1e-9) on the noam
    schedule. The test program adds the token accuracy of
    ``arg_max(logits)``. Feeds and batches are ``transformer.build``'s
    (``transformer.make_fake_batch``)."""
    import importlib
    tf = importlib.import_module(fl.__name__ + ".models.transformer")
    L = fl.layers
    d_key = d_value = d_model // n_head
    main, startup = fl.Program(), fl.Program()
    with fl.program_guard(main, startup):
        src = L.data("src_word", shape=[max_len, 1], dtype="int64")
        src_pos = L.data("src_pos", shape=[max_len, 1], dtype="int64")
        trg = L.data("trg_word", shape=[max_len, 1], dtype="int64")
        trg_pos = L.data("trg_pos", shape=[max_len, 1], dtype="int64")
        lbl = L.data("lbl_word", shape=[max_len, 1], dtype="int64")
        src_len = L.data("src_len", shape=[], dtype="int32")
        trg_len = L.data("trg_len", shape=[], dtype="int32")
        src_kb, trg_kb = [L.scale(L.cast(L.sequence_mask(
            n, maxlen=max_len, dtype="int32"), "float32"),
            scale=1e9, bias=-1e9) for n in (src_len, trg_len)]
        width = dict(n_head=n_head, d_key=d_key, d_value=d_value,
                     d_model=d_model, d_inner_hid=d_inner_hid,
                     dropout_rate=dropout_rate)
        enc = tf._embed(src, src_vocab, d_model, max_len, src_pos,
                        dropout_rate, "src")
        for i in range(n_layer):
            enc = _transformer_layer(tf.encoder_layer, enc, name=f"enc{i}",
                                     key_bias=src_kb, **width)
        enc = tf.pre_post_process_layer(None, enc, "n")
        dec = tf._embed(trg, tgt_vocab, d_model, max_len, trg_pos,
                        dropout_rate, "trg")
        for i in range(n_layer):
            dec = _transformer_layer(
                tf.decoder_layer, dec, enc, name=f"dec{i}",
                src_key_bias=src_kb, trg_key_bias=trg_kb, **width)
        dec = tf.pre_post_process_layer(None, dec, "n")
        logits = L.fc(dec, size=tgt_vocab, num_flatten_dims=2,
                      bias_attr=False, param_attr=fl.ParamAttr(name="proj.w"))
        smoothed = L.label_smooth(L.one_hot(lbl, depth=tgt_vocab),
                                  epsilon=LABEL_SMOOTH_EPS)
        cost = L.softmax_with_cross_entropy(logits, smoothed,
                                            soft_label=True)
        tok_mask = L.cast(L.sequence_mask(trg_len, maxlen=max_len,
                                          dtype="int32"), "float32")
        sum_cost = L.reduce_sum(L.elementwise_mul(L.squeeze(cost, axes=[2]),
                                                  tok_mask))
        token_num = L.reduce_sum(tok_mask)
        token_num.stop_gradient = True
        avg_cost = L.elementwise_div(sum_cost, token_num)
        hits = L.cast(L.equal(L.arg_max(logits, axis=-1),
                              L.squeeze(lbl, axes=[2])), "float32")
        accuracy = L.elementwise_div(
            L.reduce_sum(L.elementwise_mul(hits, tok_mask)), token_num)
        test = main.clone(for_test=True)
        fl.optimizer.AdamOptimizer(
            learning_rate=L.learning_rate_scheduler.noam_decay(
                d_model, warmup_steps),
            beta1=0.9, beta2=0.98, epsilon=1e-9).minimize(avg_cost)
    return {"main": main, "startup": startup, "test": test,
            "loss": avg_cost, "accuracy": accuracy, "logits": logits,
            "smoothed": smoothed,
            "feeds": ["src_word", "src_pos", "trg_word", "trg_pos",
                      "lbl_word", "src_len", "trg_len"],
            "config": {"n_layer": n_layer, "n_head": n_head,
                       "d_model": d_model, "d_inner_hid": d_inner_hid,
                       "max_len": max_len, "src_vocab": src_vocab,
                       "tgt_vocab": tgt_vocab,
                       "label_smooth_eps": LABEL_SMOOTH_EPS}}


WORD2VEC_HEADS = ("nce", "hsigmoid")
WORD2VEC_SEED = 92


def word2vec_heads(fl, head="nce", dict_size=2073, embed_size=32,
                   hidden_size=256, lr=0.001):
    """The zoo's word2vec (the book's N-gram model, ``models/word2vec.py``:
    4 context words through one shared embedding table, concatenated, an
    fc ``hidden_size`` sigmoid) with its softmax head replaced by
    ``layers.nce`` (the layer's default 10 uniform negatives) or ``layers.hsigmoid`` over the ``dict_size`` words;
    SGD, as the zoo's. Feeds are the zoo's (``word2vec.make_fake_batch``)."""
    if head not in WORD2VEC_HEADS:
        raise ValueError(f"word2vec_heads: head {head!r} not in "
                         f"{WORD2VEC_HEADS}")
    L = fl.layers
    main, startup = fl.Program(), fl.Program()
    main.random_seed = startup.random_seed = WORD2VEC_SEED
    with fl.program_guard(main, startup):
        words = [L.data(n, shape=[1], dtype="int64")
                 for n in ("firstw", "secondw", "thirdw", "forthw")]
        next_word = L.data("nextw", shape=[1], dtype="int64")
        embs = [L.embedding(w, size=[dict_size, embed_size],
                            param_attr="shared_w") for w in words]
        hidden = L.fc(L.concat(embs, axis=1), size=hidden_size,
                      act="sigmoid")
        if head == "nce":
            cost = L.nce(hidden, next_word, num_total_classes=dict_size)
        else:
            cost = L.hsigmoid(hidden, next_word, num_classes=dict_size)
        avg_cost = L.mean(cost)
        test = main.clone(for_test=True)
        fl.optimizer.SGDOptimizer(learning_rate=lr).minimize(avg_cost)
    return {"main": main, "startup": startup, "test": test,
            "loss": avg_cost, "cost": cost,
            "feeds": ["firstw", "secondw", "thirdw", "forthw", "nextw"],
            "config": {"dict_size": dict_size, "head": head}}


# SimpleBaseline human pose estimation (Xiao et al. 2018, arXiv:1804.06208)
# as PaddlePaddle/models builds it (fluid/PaddleCV/human_pose_estimation,
# lib/pose_resnet.py): ResNet-50 without its fc, three 4x4 stride-2
# deconvolutions of 256 filters, a 1x1 conv to the joints; MPII's 16
# joints at 256x256 (heatmaps 64x64), Adam at 1e-3, 32 images a card
POSE_JOINTS = 16
POSE_IMAGE = (3, 256, 256)
POSE_LR = 1e-3
POSE_BATCH = 32
POSE_SEED = 2024
# the weights' init of pose_resnet.py: N(0, 0.001) for every conv and
# deconvolution
POSE_INIT_STD = 0.001


def pose_resnet(fl, image=POSE_IMAGE, stages=(3, 4, 6, 3),
                widths=(64, 128, 256, 512), deconv=256):
    """The SimpleBaseline pose network: the ResNet-50 backbone
    (``stages`` bottlenecks of ``widths`` x 4 output channels; a 7x7
    stride-2 stem and a 3x3 max pool), then three ``conv2d_transpose``
    layers of ``deconv`` filters (4x4, stride 2, padding 1, no bias), each
    with batch_norm and relu, and a 1x1 conv to POSE_JOINTS heatmaps of a
    quarter of the image's side. The loss is the target-weighted MSE,
    ``mean(square_error_cost(heatmaps * w, target * w))`` over the
    heatmaps flattened to [B, joints, H * W] with ``w`` [B, joints, 1];
    Adam at POSE_LR. The test program is cloned ``for_test`` before the
    backward (batch_norm on its running statistics).

    Feeds: ``image`` [B, *image] float32, ``target`` [B, joints, H/4,
    W/4] float32 and ``target_weight`` [B, joints, 1] float32."""
    L = fl.layers
    joints = POSE_JOINTS

    def param():
        return fl.ParamAttr(initializer=fl.initializer.NormalInitializer(
            0.0, POSE_INIT_STD))

    def conv_bn(x, ch, size, stride=1, act=None):
        conv = L.conv2d(x, num_filters=ch, filter_size=size, stride=stride,
                        padding=(size - 1) // 2, param_attr=param(),
                        bias_attr=False)
        return L.batch_norm(conv, act=act)

    def bottleneck(x, ch, stride):
        short = (conv_bn(x, ch * 4, 1, stride) if x.shape[1] != ch * 4
                 or stride != 1 else x)
        y = conv_bn(x, ch, 1, act="relu")
        y = conv_bn(y, ch, 3, stride, act="relu")
        y = conv_bn(y, ch * 4, 1)
        return L.elementwise_add(short, y, act="relu")

    main, startup = fl.Program(), fl.Program()
    main.random_seed = startup.random_seed = POSE_SEED
    side = image[1] // 4
    with fl.unique_name.guard(), fl.program_guard(main, startup):
        img = L.data(name="image", shape=list(image), dtype="float32")
        target = L.data(name="target", shape=[joints, side, image[2] // 4],
                        dtype="float32")
        weight = L.data(name="target_weight", shape=[joints, 1],
                        dtype="float32")
        x = conv_bn(img, widths[0], 7, 2, act="relu")
        x = L.pool2d(x, pool_size=3, pool_stride=2, pool_padding=1,
                     pool_type="max")
        for block, (count, ch) in enumerate(zip(stages, widths)):
            for i in range(count):
                x = bottleneck(x, ch, 2 if i == 0 and block else 1)
        for _ in range(3):
            x = L.conv2d_transpose(x, num_filters=deconv, filter_size=4,
                                   padding=1, stride=2, param_attr=param(),
                                   bias_attr=False)
            x = L.batch_norm(x, act="relu")
        heatmaps = L.conv2d(x, num_filters=joints, filter_size=1,
                            param_attr=param())
        flat = [joints, side * (image[2] // 4)]
        pred = L.elementwise_mul(L.reshape(heatmaps, [-1] + flat), weight)
        want = L.elementwise_mul(L.reshape(target, [-1] + flat), weight)
        loss = L.mean(L.square_error_cost(pred, want))
        test = main.clone(for_test=True)
        fl.optimizer.Adam(learning_rate=POSE_LR).minimize(loss)
    return {"main": main, "startup": startup, "test": test, "loss": loss,
            "heatmaps": heatmaps,
            "feeds": ["image", "target", "target_weight"],
            "config": {"image": tuple(image), "joints": joints,
                       "heatmap": (side, image[2] // 4)}}


def pose_batch(batch, image, joints, seed):
    """Seeded pose feeds: uniform images, a Gaussian heatmap (sigma 2, the
    paper's) at a random point of each joint's map, and joint weights of
    1 with one joint in eight at 0 (not visible)."""
    import numpy as np
    rng = np.random.RandomState(seed)
    h, w = image[1] // 4, image[2] // 4
    ys, xs = np.mgrid[0:h, 0:w]
    cy = rng.uniform(0, h, (batch, joints, 1, 1))
    cx = rng.uniform(0, w, (batch, joints, 1, 1))
    target = np.exp(-((ys - cy) ** 2 + (xs - cx) ** 2) / (2 * 2.0 ** 2))
    weight = (rng.rand(batch, joints, 1) >= 0.125).astype(np.float32)
    return {"image": rng.rand(batch, *image).astype(np.float32),
            "target": target.astype(np.float32), "target_weight": weight}
