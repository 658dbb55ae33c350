from modular_slam_tpu_torch.loop.vocab import (  # noqa: F401
    bow_histogram,
    load_trained_vocab,
    make_vocab,
    train_vocab,
)
from modular_slam_tpu_torch.loop.detector import (  # noqa: F401
    LoopDatabase,
    empty_database,
    add_keyframe_bow,
    query_candidates,
    geometric_verify,
)
from modular_slam_tpu_torch.loop.relocalizer import (  # noqa: F401
    make_relocalizer,
)
