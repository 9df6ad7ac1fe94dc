from portbench.reference.losses.losses import (
    seg_loss, teacher_temp_schedule, dino_char_loss, dino_char_loss_fused,
    dino_center_update, sinkhorn_knopp_teacher, tf_loss,
)
