"""The demo programs of the JAX package's ``scripts/``, on the port.

Each module is ``python -m oetr_tpu_torch.scripts.<name>`` with the JAX
script's flags and defaults plus ``--device cuda|cpu`` (the card unless
asked), and prints the JSON line the JAX script prints:

  ``train_demo``           a small OETR from scratch on synthetic scenes,
                           the IoU-recall table before and after
  ``train_matching_demo``  SuperPoint (joint detector/descriptor step,
                           host or ``--device_data`` batches), SuperGlue on
                           its keypoints, the SIFT+NN / SP+NN / SP+SG table
  ``train_loftr_demo``     LoFTR on the on-device scene generator, its
                           pose-AUC row beside SIFT+NN
  ``eval_demo``            SIFT -> NN -> RANSAC -> pose AUC
  ``overlap_ab_demo``      OETR on scale-difference pairs, then direct,
                           OETR-guided and GT-guided matching
  ``probe_heatmap_boxes``  a trained state's boxes from the heat map
                           against the tlbr head's (mIoU), ``--full`` the
                           pose A/B
  ``sweep_decode``         the heat-map decode's (q, pad) grid by pose AUC
  ``export_params``        a full train state's params-only store

Their phases are functions that take their weights and their items, so a
caller can feed other weights or the on-device generator's pairs; ``main``
only wires them together. Checkpoints (``--ckpt_dir``, ``step_N``) are
JAX's orbax directories, read and written by the port's own code, so the
port and the JAX scripts resume each other's runs. cv2 is needed for the
host scene writer, the dataset reads, the host texture pairs and every
SIFT row, as in JAX; where a chosen flag needs it and it is missing,
``main`` stops before any training with an ImportError naming cv2.
"""
