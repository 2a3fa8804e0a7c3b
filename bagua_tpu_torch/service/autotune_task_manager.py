"""Per-model autotune task manager.

Counterpart of the reference's bagua/service/autotune_task_manager.py:21-185:
keeps the (train_iter, hyperparameters, speed) sample history, re-orders the
tensor list by the observed execution partial order, asks the optimizer for
the next (bucket_size, is_hierarchical_reduce) point, and materializes it into
concrete buckets via :func:`split_bucket_by_bucket_size`.

The search dimension gains one axis over the reference: the
algorithm *family* is part of the tunable space when ``tune_algorithm`` is on
(BASELINE.json requires the centralized / decentralized / low-precision
families to be selectable by the autotuner).

Autotune v2: when the trainer reports capabilities at tensor
registration, :meth:`AutotuneTaskManager.configure_space` swaps the legacy
two-knob space for the full capability-gated knob space
(:mod:`.knob_space`) — overlap + per-tier chunk bytes, the codec ladder,
flat residency, and family switching — with conditional sampling so
inactive knobs never burn samples.  Tasks without capabilities keep the
legacy space and materialization byte-for-byte.
"""

from __future__ import annotations

import csv
import logging
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

from ..bucket import split_bucket_by_bucket_size
from ..define import BaguaHyperparameter, TensorDeclaration
from .bayesian_optimizer import BayesianOptimizer, BoolParam, IntParam
from .knob_space import KnobSpace, build_knob_space

logger = logging.getLogger(__name__)

MIN_BUCKET_SIZE_EXP = 10   # 1 KiB
MAX_BUCKET_SIZE_EXP = 31   # 2 GiB   (reference: 2^10 .. 2^31)

# Only families the trainer can hot-swap mid-training — the stateless
# replicated pair plus QAdam, whose param-shaped momenta ride the trainer's
# state-migration adapter (see algorithms.SWITCHABLE_ALGORITHMS).  Gossip and
# sharded-opt-state families change the TrainState layout irreversibly, so
# recommending them would record scores against configs the trainer silently
# cannot apply.
ALGORITHM_FAMILIES = ["gradient_allreduce", "bytegrad", "qadam"]


class AutotuneTaskManager:
    def __init__(
        self,
        task_name: str,
        is_output_autotune_log: bool,
        tune_algorithm: bool = False,
        log_path: Optional[str] = None,
    ):
        self.task_name = task_name
        params = [
            IntParam("bucket_size_2p", MIN_BUCKET_SIZE_EXP, MAX_BUCKET_SIZE_EXP),
            BoolParam("is_hierarchical_reduce"),
        ]
        if tune_algorithm:
            params.append(IntParam("algorithm_index", 0, len(ALGORITHM_FAMILIES) - 1))
        self.tune_algorithm = tune_algorithm
        self.optimizer = BayesianOptimizer(params)
        #: v2 knob space (None = legacy two-knob space); set once via
        #: :meth:`configure_space` from the task's registration capabilities
        self.space: Optional[KnobSpace] = None
        # sample history: (train_iter, hyperparameters, score)
        self.records: Deque[Tuple[int, BaguaHyperparameter, float]] = deque(maxlen=100)
        self.tensor_partial_order: Dict[str, int] = {}
        self._log_writer = None
        if is_output_autotune_log:
            path = log_path or f"/tmp/bagua_autotune_{task_name}_{int(time.time())}.csv"
            f = open(path, "a", newline="")
            self._log_writer = csv.writer(f)
            self._log_writer.writerow(
                ["train_iter", "bucket_size", "is_hierarchical_reduce", "score"]
            )
            self._log_file = f
            logger.info("autotune log -> %s", path)

    def configure_space(self, capabilities: Optional[Dict]) -> None:
        """Swap in the capability-gated v2 knob space (idempotent; no-op
        for legacy/absent capabilities or once sampling has begun — a
        mid-search space change would orphan every observation)."""
        if self.space is not None or self.records:
            return
        space = build_knob_space(capabilities, self.tune_algorithm)
        if space is None:
            return
        self.space = space
        self.optimizer = BayesianOptimizer(
            space.params, conditions=space.conditions
        )
        logger.info(
            "autotune[%s]: v2 knob space active (%s)",
            self.task_name, ", ".join(space.names()),
        )

    def prime(self, updates: Dict) -> None:
        """Warm-start prior from an autopilot hint / historian trend:
        queue a point near the current best with ``updates`` applied
        (hyperparameter-field names == v2 param names)."""
        self.optimizer.prime(updates)

    def weight_coordinate(self, name: str, w: float) -> None:
        """Bias the exploit step toward one coordinate (trend weighting)."""
        self.optimizer.weight(name, w)

    def record_sample(
        self, train_iter: int, hp: BaguaHyperparameter, score: float
    ) -> None:
        self.records.append((train_iter, hp, score))
        if self._log_writer:
            self._log_writer.writerow(
                [train_iter, hp.bucket_size, hp.is_hierarchical_reduce, score]
            )
            self._log_file.flush()

    def report_tensor_execution_order(self, ordered_names: List[str]) -> None:
        """Record the observed grad-ready order; buckets are rebuilt in this
        order so the head-of-ring fills first (reference
        autotune_task_manager.py:167-172 re-sorts by telemetry)."""
        for i, name in enumerate(ordered_names):
            self.tensor_partial_order[name] = i

    def _order_tensors(
        self, tensor_list: List[TensorDeclaration]
    ) -> List[TensorDeclaration]:
        if not self.tensor_partial_order:
            return list(tensor_list)
        n = len(self.tensor_partial_order)
        return sorted(
            tensor_list,
            key=lambda t: self.tensor_partial_order.get(t.name, n),
        )

    def ask_hyperparameters(
        self,
        train_iter: int,
        tensor_list: List[TensorDeclaration],
        last_hp: BaguaHyperparameter,
        last_score: Optional[float],
    ) -> BaguaHyperparameter:
        """tell the last sample's score, ask the next point, materialize it."""
        if self.space is not None:
            if last_score is not None:
                self.optimizer.tell(
                    self.space.point_from_hp(last_hp), last_score
                )
            return self._materialize(self.optimizer.ask(), tensor_list, last_hp)
        if last_score is not None:
            point = {
                "bucket_size_2p": max(last_hp.bucket_size, 1).bit_length() - 1,
                "is_hierarchical_reduce": bool(last_hp.is_hierarchical_reduce),
            }
            if self.tune_algorithm:
                algo = last_hp.algorithm or ALGORITHM_FAMILIES[0]
                point["algorithm_index"] = (
                    ALGORITHM_FAMILIES.index(algo)
                    if algo in ALGORITHM_FAMILIES else 0
                )
            self.optimizer.tell(point, last_score)
        nxt = self.optimizer.ask()
        return self._materialize(nxt, tensor_list, last_hp)

    def _materialize(
        self, point: Dict, tensor_list: List[TensorDeclaration],
        last_hp: Optional[BaguaHyperparameter] = None,
    ) -> BaguaHyperparameter:
        bucket_size = 2 ** point["bucket_size_2p"]
        ordered = self._order_tensors(tensor_list)
        if self.space is not None:
            # v2: searched knobs come from the point (inactive ones emit
            # their keep-current sentinel), unsearched knobs carry through
            hp = BaguaHyperparameter(
                buckets=split_bucket_by_bucket_size(ordered, bucket_size),
                bucket_size=bucket_size,
                overlap_chunk_bytes=(
                    last_hp.overlap_chunk_bytes if last_hp is not None else 0
                ),
            )
            if last_hp is not None:
                for fld in ("is_hierarchical_reduce", "overlap",
                            "overlap_chunk_bytes_intra",
                            "overlap_chunk_bytes_inter",
                            "compress_intra", "compress_inter",
                            "flat_resident"):
                    setattr(hp, fld, getattr(last_hp, fld))
            hp.update(self.space.point_to_updates(point))
            return hp
        return BaguaHyperparameter(
            buckets=split_bucket_by_bucket_size(ordered, bucket_size),
            bucket_size=bucket_size,
            is_hierarchical_reduce=bool(point["is_hierarchical_reduce"]),
            algorithm=(
                ALGORITHM_FAMILIES[point["algorithm_index"]]
                if self.tune_algorithm else ""
            ),
            # overlap knobs are carried through, not searched: the trainer's
            # reported values survive re-bucketing recommendations ("" / 0
            # means "keep current" on the trainer side either way)
            overlap=(last_hp.overlap if last_hp is not None else ""),
            overlap_chunk_bytes=(
                last_hp.overlap_chunk_bytes if last_hp is not None else 0
            ),
            overlap_chunk_bytes_intra=(
                last_hp.overlap_chunk_bytes_intra if last_hp is not None else 0
            ),
            overlap_chunk_bytes_inter=(
                last_hp.overlap_chunk_bytes_inter if last_hp is not None else 0
            ),
            # the codec policy is carried through like the overlap knobs —
            # the autopilot's actuated compress_inter must survive every
            # later re-bucketing recommendation
            compress_intra=(
                last_hp.compress_intra if last_hp is not None else ""
            ),
            compress_inter=(
                last_hp.compress_inter if last_hp is not None else ""
            ),
        )

    def best_hyperparameters(
        self, tensor_list: List[TensorDeclaration]
    ) -> Optional[BaguaHyperparameter]:
        best = self.optimizer.best()
        if best is None:
            return None
        point, _ = best
        return self._materialize(point, tensor_list)

    def close(self) -> None:
        if self._log_writer is not None:
            self._log_file.close()
            self._log_writer = None
