"""Model import (counterpart of ``deeplearning4j_tpu.imports``).

Ported: ``TFGraphMapper`` (:mod:`.tf_import`), the TF GraphDef importer,
reading the protobuf with the port's own reader (:mod:`.graphdef_proto`)
so that it runs without tensorflow; and the imported-BERT workload's
builders (:mod:`.tf_oracles`). Not ported yet: ``KerasModelImport`` and
``OnnxGraphMapper``.
"""

from deeplearning4j_tpu_torch.imports.tf_import import TFGraphMapper
from deeplearning4j_tpu_torch.imports.tf_oracles import (bert_synthetic_batch,
                                                         build_bert_samediff,
                                                         graft_classifier)

__all__ = ["TFGraphMapper", "bert_synthetic_batch", "build_bert_samediff",
           "graft_classifier"]
