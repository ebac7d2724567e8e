"""tpu-pose: 3D human pose estimation in JAX.

A ground-up JAX/XLA rebuild of the capability surface of the five-phase
research stack RHnejad/3D_PoseEstimation (reference mounted at /root/reference):

- ``core``     — skeleton constants, quaternion/camera math, pose transforms
                 (reference: phase3_direct/my_HybrIK/utils.py, phase2_opp_mb/run.py)
- ``data``     — Human3.6M keypoint pipeline, normalization statistics,
                 double-buffered host->device feed
                 (reference: phase3_direct/my_HybrIK/H36_dataset.py)
- ``models``   — lifters (Martinez residual MLP, joint-token transformer),
                 ResNet backbones, volumetric-heatmap heads, temporal transformer,
                 SMPL/HybrIK (reference: phase1_lifting/baselineModel.py,
                 phase3_direct/my_HybrIK/{Model,Resnet,SMPL,lbs}.py)
- ``ops``      — soft-argmax decoding and Gaussian heatmaps (plain XLA)
- ``losses``   — MPJPE, triangle cycle-consistency losses
                 (reference: phase5_loop/losses.py)
- ``parallel`` — device mesh + sharding strategy (new: the reference is
                 single-GPU; see SURVEY.md section 2.7)
- ``train``    — jitted train steps, plateau LR schedule, checkpointing, metrics
- ``pipeline`` — video -> 2D keypoints -> 3D lifting ETL
                 (reference: phase2_opp_mb/run.py)
"""

__version__ = "0.1.0"
