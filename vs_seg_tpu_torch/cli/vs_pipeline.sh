#!/bin/bash
# Train-then-infer pipeline of the port (the root vs_pipeline.sh's
# counterpart, reference vs_pipeline.sh): the same results folder, dataset
# and stderr logs, on the port's two CLIs. Run it from the directory that
# holds params/ and the data, as the root script is run.

RESULTS_FOLDER_NAME="UNet2d5_Att_Hard_T2"

python3 -m vs_seg_tpu_torch.cli.train     --results_folder_name $RESULTS_FOLDER_NAME --dataset T2   2> train_error_log.txt
python3 -m vs_seg_tpu_torch.cli.inference --results_folder_name $RESULTS_FOLDER_NAME --dataset T2   2> inference_error_log.txt
