"""InferenceTranspiler (counterpart of
``paddle_tpu/inference/transpiler.py``; reference
transpiler/inference_transpiler.py).

Program -> program rewrite preparing a trained program for serving: flips
train-only ops to test mode, drops identity scales, folds batch norms into
convolutions (by value, from the scope's trained weights) and fuses fc.
The passes live in ``paddle_tpu_torch/ir``; this class keeps the
reference's API shape.
"""

from __future__ import annotations


class InferenceTranspiler:
    PASSES = ("is_test_pass", "identity_scale_op_clean_pass",
              "conv_bn_fuse_pass", "fc_fuse_pass")

    def transpile(self, program, place=None, scope=None, protected=()):
        from .. import executor, ir
        scope = scope or executor.global_scope()
        ir.apply_passes(program, self.PASSES, scope=scope,
                        protected=protected)
        return program
