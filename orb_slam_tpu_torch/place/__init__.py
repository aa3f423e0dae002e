"""Place recognition: vocabulary tree, BoW vectors, keyframe database.

Port of orb_slam_tpu/place/ (`__init__.py`:1-13, with `vocabulary.py`,
`database.py` and `pretrained.py`), which replaces DBoW2
(Thirdparty/DBoW2) and the reference's KeyFrameDatabase
(src/KeyFrameDatabase.cc): the vocabulary as flat arrays, `transform`
descending all descriptors at once, BoW vectors as fixed-size sorted
sparse arrays, and a query scored against every keyframe in one batched
merge.
"""

from orb_slam_tpu_torch.place.vocabulary import (
    Vocabulary, train_vocabulary, transform, bow_vector, l1_score,
)
from orb_slam_tpu_torch.place.database import KeyFrameDatabase
