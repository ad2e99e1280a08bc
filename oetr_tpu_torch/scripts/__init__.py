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

Their phases are functions that take their weights and their items, so a
caller can feed other weights or the on-device generator's pairs; ``main``
only wires them together. Checkpoints are torch files (``--ckpt_dir``);
the JAX scripts' orbax directories are not read. cv2 is needed for the
host scene writer, the dataset reads, the host texture pairs and every
SIFT row, as in JAX; where a chosen flag needs it and it is missing,
``main`` stops before any training with an ImportError naming cv2.
"""
