from .loop import (
    epoch_permutation,
    eval_epoch,
    metrics_to_host,
    padded_eval_batches,
    train_epoch_alternated,
    train_epoch_alternated_pair,
    train_epoch_classifier,
)
from .schedules import multistep_lr, multistep_lr_resume, sgd_torch
from .state import TrainState, freeze
from .steps import (
    AlternatedDraws,
    VictimDraws,
    backdoor_eval_forward,
    cross_entropy,
    draw_alternated,
    draw_victim,
    make_alternated_train_step,
    make_attack_eval_step,
    make_clean_eval_step,
    make_clean_train_step,
    make_victim_eval_step,
    make_victim_train_step,
)
from .variants import (
    InputawareDraws,
    PairSigmas,
    WanetDraws,
    draw_inputaware,
    draw_pair_sigmas,
    draw_wanet,
    make_imperceptible_train_step,
    make_inputaware_eval_step,
    make_inputaware_train_step,
    make_inputaware_victim_eval_step,
    make_multilabel_eval_step,
    make_multilabel_train_step,
    make_wanet_eval_step,
    make_wanet_train_step,
    make_wanet_victim_eval_step,
    make_wanet_victim_train_step,
)
