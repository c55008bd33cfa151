"""batch-operations service (reference: service-batch-operations,
[SURVEY.md §2.2, §3.4]): long-running operations over device lists —
chunked elements through the bus, progress tracking, throttling — plus
the north star's training trigger [BASELINE.json]: a batch operation
whose processor is a training job over the event store.

Operation types:
- `command-invocation` (reference parity): invoke a command on every
  device in the list; elements chunked onto the batch-elements topic and
  processed with optional throttling.
- `train-model` (north star): snapshot the tenant's telemetry, cut
  windows, train on the runtime's device, checkpoint (the npz layout,
  training/checkpoint.py), hot-swap the scoring session's params,
  record the loss curve in the operation result.
- `maintenance-gnn`: build the fleet graph, train the GNN, score every
  device's risk on the runtime's device and raise maintenance alerts.

Training and the sweep run where the rest of the scoring plane runs:
`InstanceSettings.device`, resolved once when the service is built (the
card when it is None; no probe, no fallback), as rule-processing does.

API: `submit_command_operation(...)`, `submit_training_operation(...)`,
`get_operation(id)`, `list_operations()`.
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
import time
from typing import Optional, Sequence

from sitewhere_tpu_torch.config import TenantConfig
from sitewhere_tpu_torch.domain.events import DeviceCommandInvocation
from sitewhere_tpu_torch.domain.model import (
    BatchElement,
    BatchElementStatus,
    BatchOperation,
    BatchOperationStatus,
)
from sitewhere_tpu_torch.kernel.bus import TopicNaming
from sitewhere_tpu_torch.kernel.lifecycle import BackgroundTaskComponent
from sitewhere_tpu_torch.kernel.service import Service, TenantEngine
from sitewhere_tpu_torch.persistence.memory import InMemoryBatchManagement
from sitewhere_tpu_torch.utils import resolve_device

logger = logging.getLogger(__name__)


class BatchOperationsEngine(TenantEngine):
    def __init__(self, service: "BatchOperationsService", tenant: TenantConfig):
        super().__init__(service, tenant)
        cfg = tenant.section("batch-operations", {})
        self.spi = InMemoryBatchManagement()
        self.chunk_size = cfg.get("chunk_size", 100)
        self.throttle_ms = cfg.get("throttle_ms", 0.0)
        self.checkpoint_root = cfg.get("checkpoint_root", ".checkpoints")
        self.processor = BatchElementProcessor(self)
        self.add_child(self.processor)

    # -- submission API (reference: BatchOperationManager) -----------------

    async def submit_command_operation(
            self, device_ids: Sequence[str], command_id: str,
            parameters: Optional[dict] = None,
            initiator: str = "rest", initiator_id: str = "") -> BatchOperation:
        op = BatchOperation(
            operation_type="command-invocation",
            parameters={"command_id": command_id,
                        "parameter_values": parameters or {},
                        "initiator": initiator, "initiator_id": initiator_id},
            processing_status=BatchOperationStatus.INITIALIZING)
        self.spi.create_batch_operation(op)
        elements = [BatchElement(batch_operation_id=op.id, device_id=d)
                    for d in device_ids]
        self.spi.create_batch_elements(elements)
        if not elements:  # empty list: nothing to do, don't hang PROCESSING
            return self._set_status(op.id,
                                    BatchOperationStatus.FINISHED_SUCCESSFULLY,
                                    started=True, ended=True)
        # chunk element ids onto the bus (reference §3.4: chunked via Kafka)
        topic = self.tenant_topic(TopicNaming.BATCH_ELEMENTS)
        for lo in range(0, len(elements), self.chunk_size):
            chunk = [e.id for e in elements[lo:lo + self.chunk_size]]
            await self.runtime.bus.produce(
                topic, {"operation_id": op.id, "element_ids": chunk},
                key=op.id)
        return self._set_status(op.id, BatchOperationStatus.PROCESSING,
                                started=True)

    async def submit_training_operation(
            self, model_name: Optional[str] = None, *,
            steps: int = 200, batch_size: int = 1024,
            learning_rate: float = 1e-3, window: Optional[int] = None,
            max_windows: int = 200_000, mtype: int = 0) -> BatchOperation:
        op = BatchOperation(
            operation_type="train-model",
            parameters={"model": model_name, "steps": steps,
                        "batch_size": batch_size, "lr": learning_rate,
                        "window": window, "max_windows": max_windows,
                        "mtype": mtype},
            processing_status=BatchOperationStatus.INITIALIZING)
        self.spi.create_batch_operation(op)
        await self.runtime.bus.produce(
            self.tenant_topic(TopicNaming.BATCH_ELEMENTS),
            {"operation_id": op.id, "train": True}, key=op.id)
        return self._set_status(op.id, BatchOperationStatus.PROCESSING,
                                started=True)

    async def submit_maintenance_operation(
            self, *, hidden: int = 32, layers: int = 2, max_degree: int = 16,
            steps: int = 200, learning_rate: float = 1e-2,
            window: int = 64, mtype: int = 0,
            risk_threshold: float = 0.7, emit_alerts: bool = True,
            feature_dropout: float = 0.3,
            label_alert_types: Optional[Sequence[str]] = None,
            alert_type: str = "maintenance.risk") -> BatchOperation:
        """Fleet predictive-maintenance sweep (config 5 [BASELINE.json]):
        build the device-asset graph, train the GNN on alert history,
        score every device, raise maintenance alerts above threshold."""
        op = BatchOperation(
            operation_type="maintenance-gnn",
            parameters={"hidden": hidden, "layers": layers,
                        "max_degree": max_degree, "steps": steps,
                        "lr": learning_rate, "window": window,
                        "mtype": mtype, "risk_threshold": risk_threshold,
                        "emit_alerts": emit_alerts, "alert_type": alert_type,
                        "feature_dropout": feature_dropout,
                        "label_alert_types": (list(label_alert_types)
                                              if label_alert_types else None)},
            processing_status=BatchOperationStatus.INITIALIZING)
        self.spi.create_batch_operation(op)
        await self.runtime.bus.produce(
            self.tenant_topic(TopicNaming.BATCH_ELEMENTS),
            {"operation_id": op.id, "maintenance": True}, key=op.id)
        return self._set_status(op.id, BatchOperationStatus.PROCESSING,
                                started=True)

    def _set_status(self, op_id: str, status: BatchOperationStatus,
                    started: bool = False, ended: bool = False,
                    result: Optional[dict] = None) -> BatchOperation:
        op = self.spi.get_batch_operation(op_id)
        changes: dict = {"processing_status": status}
        if started:
            changes["processing_started_date"] = time.time()
        if ended:
            changes["processing_ended_date"] = time.time()
        if result is not None:
            changes["parameters"] = {**op.parameters, "result": result}
        return self.spi.update_batch_operation(
            dataclasses.replace(op, **changes))

    def get_operation(self, op_id: str) -> Optional[BatchOperation]:
        return self.spi.get_batch_operation(op_id)

    async def wait_for_operation(self, op_id: str,
                                 timeout: float = 60.0) -> BatchOperation:
        deadline = time.monotonic() + timeout
        terminal = (BatchOperationStatus.FINISHED_SUCCESSFULLY,
                    BatchOperationStatus.FINISHED_WITH_ERRORS)
        while True:
            op = self.spi.get_batch_operation(op_id)
            if op is not None and op.processing_status in terminal:
                return op
            if time.monotonic() > deadline:
                raise TimeoutError(f"operation {op_id} not finished")
            await asyncio.sleep(0.05)

    def __getattr__(self, name):
        return getattr(self.spi, name)


class BatchElementProcessor(BackgroundTaskComponent):
    """(reference: BatchElementProcessor) consumes element chunks."""

    def __init__(self, engine: BatchOperationsEngine):
        super().__init__("batch-element-processor")
        self.engine = engine

    async def _run(self) -> None:
        engine = self.engine
        runtime = engine.runtime
        tenant_id = engine.tenant_id
        consumer = runtime.bus.subscribe(
            engine.tenant_topic(TopicNaming.BATCH_ELEMENTS),
            group=f"{tenant_id}.batch-operations")
        processed = runtime.metrics.counter("batch.elements_processed")
        # clean-handoff commit-through (same contract as the inbound
        # processor): a cancellation mid-batch must not lose a handled
        # chunk's commit — a redelivery would re-execute the chunk's
        # commands against devices. The finally commits the handled
        # prefix exactly.
        handled: dict[tuple[str, int], int] = {}
        try:
            while True:
                for record in await consumer.poll(max_records=16, timeout=0.5):
                    chunk = None
                    try:
                        chunk = record.value
                        if not isinstance(chunk, dict) \
                                or "operation_id" not in chunk:
                            # a non-chunk on the elements topic used to
                            # poison the loop TWICE: the AttributeError
                            # here and then chunk["operation_id"] in the
                            # old error path — straight to the DLQ
                            raise TypeError(
                                f"not a batch-element chunk: {type(chunk)}")
                        if chunk.get("train"):
                            await self._run_training(chunk["operation_id"])
                        elif chunk.get("maintenance"):
                            await self._run_maintenance(chunk["operation_id"])
                        else:
                            n = await self._process_command_chunk(chunk)
                            processed.inc(n)
                    except asyncio.CancelledError:
                        raise
                    except Exception as exc:  # noqa: BLE001 - quarantined
                        logger.exception("batch chunk failed")
                        await engine.dead_letter(record, exc, self.path)
                        if isinstance(chunk, dict) and \
                                engine.spi.get_batch_operation(
                                    chunk.get("operation_id", "")) is not None:
                            engine._set_status(
                                chunk["operation_id"],
                                BatchOperationStatus.FINISHED_WITH_ERRORS,
                                ended=True)
                    # slotted-attribute reads cannot raise — bookkeeping
                    handled[(record.topic, record.partition)] = record.offset + 1  # swxlint: disable=DLQ01
                consumer.commit()
        finally:
            try:
                if handled:
                    # commit the handled prefix (see above)
                    consumer.commit(dict(handled))
            except RuntimeError:
                pass
            consumer.close()

    # -- command invocation elements ---------------------------------------

    async def _process_command_chunk(self, chunk: dict) -> int:
        engine = self.engine
        runtime = engine.runtime
        tenant_id = engine.tenant_id
        op = engine.spi.get_batch_operation(chunk["operation_id"])
        if op is None:
            return 0
        em = await runtime.wait_for_engine("event-management", tenant_id)
        dm = await runtime.wait_for_engine("device-management", tenant_id)
        elements = {e.id: e for e in
                    engine.spi.list_batch_elements(op.id)}
        count = 0
        for el_id in chunk["element_ids"]:
            el = elements.get(el_id)
            if el is None or el.processing_status != BatchElementStatus.UNPROCESSED:
                continue  # idempotent under at-least-once redelivery
            device = dm.get_device(el.device_id)
            ok = device is not None
            if ok:
                assignments = dm.get_active_assignments_for_device(device.id)
                inv = DeviceCommandInvocation(
                    device_id=device.id,
                    assignment_id=assignments[0].id if assignments else "",
                    initiator=op.parameters.get("initiator", "batch"),
                    initiator_id=op.id,
                    command_id=op.parameters["command_id"],
                    parameter_values=op.parameters.get("parameter_values", {}))
                await em.add_command_invocations([inv])
            engine.spi.update_batch_element(dataclasses.replace(
                el,
                processing_status=(BatchElementStatus.SUCCEEDED if ok
                                   else BatchElementStatus.FAILED),
                processed_date=time.time()))
            count += 1
            if engine.throttle_ms:
                await asyncio.sleep(engine.throttle_ms / 1e3)
        self._maybe_finish(op.id)
        return count

    def _maybe_finish(self, op_id: str) -> None:
        engine = self.engine
        elements = engine.spi.list_batch_elements(op_id)
        if any(e.processing_status in (BatchElementStatus.UNPROCESSED,
                                       BatchElementStatus.PROCESSING)
               for e in elements):
            return
        failed = any(e.processing_status == BatchElementStatus.FAILED
                     for e in elements)
        engine._set_status(
            op_id,
            BatchOperationStatus.FINISHED_WITH_ERRORS if failed
            else BatchOperationStatus.FINISHED_SUCCESSFULLY,
            ended=True)

    # -- training operations (north star) ----------------------------------

    async def _run_training(self, op_id: str) -> None:
        from sitewhere_tpu_torch.models.registry import build_model
        from sitewhere_tpu_torch.training.checkpoint import CheckpointStore
        from sitewhere_tpu_torch.training.trainer import Trainer, TrainerConfig, make_windows

        engine = self.engine
        runtime = engine.runtime
        tenant_id = engine.tenant_id
        op = engine.spi.get_batch_operation(op_id)
        p = op.parameters

        em = await runtime.wait_for_engine("event-management", tenant_id)
        rule_service = runtime.services.get("rule-processing")
        rule_engine = rule_service.engines.get(tenant_id) if rule_service else None

        model_name = p.get("model") or (rule_engine.model_name if rule_engine
                                        else "lstm")
        model_cfg = dict(rule_engine.model_config) if rule_engine and \
            rule_engine.model_name == model_name else {}
        if p.get("window"):
            model_cfg["window"] = p["window"]
        model = build_model(model_name, device=engine.service.device,
                            **model_cfg)

        # dataset: snapshot the columnar store (zero ETL [SURVEY.md §7])
        values, counts = em.telemetry.snapshot(mtype=p.get("mtype", 0))
        windows, valid = make_windows(values, counts, model.cfg.window,
                                      stride=max(1, model.cfg.window // 4),
                                      max_windows=p.get("max_windows"))
        if windows.shape[0] == 0:
            engine._set_status(op_id, BatchOperationStatus.FINISHED_WITH_ERRORS,
                               ended=True,
                               result={"error": "no training windows"})
            return

        trainer = Trainer(model, TrainerConfig(
            learning_rate=p.get("lr", 1e-3), batch_size=p.get("batch_size", 1024),
            steps=p.get("steps", 200)))
        t0 = time.monotonic()
        params, report = trainer.train(windows, valid)
        report["windows"] = int(windows.shape[0])
        report["train_seconds"] = round(time.monotonic() - t0, 3)

        # checkpoint + hot-swap (reference §5.4 analog + north star rollout)
        store = CheckpointStore(engine.checkpoint_root)
        version = store.save(tenant_id, model_name,
                             params, metadata={"report": {
                                 k: v for k, v in report.items()
                                 if k != "losses"}})
        report["checkpoint_version"] = version
        if rule_engine is not None and rule_engine.session is not None \
                and rule_engine.model_name == model_name:
            rule_engine.swap_model_params(params)
            report["hot_swapped"] = True
        engine._set_status(op_id, BatchOperationStatus.FINISHED_SUCCESSFULLY,
                           ended=True, result=report)

    # -- predictive maintenance (config 5) ---------------------------------

    async def _run_maintenance(self, op_id: str) -> None:
        """Device-asset graph → GNN trained on alert history → per-device
        risk → maintenance alerts (config 5 [BASELINE.json])."""
        import numpy as np

        from sitewhere_tpu_torch.domain.batch import AlertBatch, BatchContext
        from sitewhere_tpu_torch.models.graph import build_fleet_graph
        from sitewhere_tpu_torch.training.checkpoint import CheckpointStore
        from sitewhere_tpu_torch.training.maintenance import (
            MaintenanceTrainer,
            MaintenanceTrainerConfig,
            build_maintenance_model,
        )

        engine = self.engine
        runtime = engine.runtime
        tenant_id = engine.tenant_id
        op = engine.spi.get_batch_operation(op_id)
        p = op.parameters

        em = await runtime.wait_for_engine("event-management", tenant_id)
        dm = await runtime.wait_for_engine("device-management", tenant_id)

        # labels = devices with incident history in the event store (the
        # durable label source). The sweep's own predictions and the
        # streaming anomaly alerts are NOT incidents — treating them as
        # ground truth would make every false positive self-reinforcing
        # (predicted → labeled failed → alerting suppressed forever).
        label_types = p.get("label_alert_types")
        failed = set()
        for alert in em.list_alerts(limit=1_000_000):
            if label_types is not None:
                if alert.type not in label_types:
                    continue
            elif (alert.type == p["alert_type"]
                    or alert.type.startswith("anomaly.")):
                continue
            device = dm.get_device(alert.device_id)
            if device is not None and device.index >= 0:
                failed.add(device.index)
        graph = build_fleet_graph(
            dm, em.telemetry, window=p["window"],
            max_degree=p["max_degree"], mtype=p["mtype"],
            failed_device_indices=np.asarray(sorted(failed), np.int64))

        model = build_maintenance_model(hidden=p["hidden"],
                                        layers=p["layers"],
                                        max_degree=p["max_degree"],
                                        device=engine.service.device)
        trainer = MaintenanceTrainer(model, MaintenanceTrainerConfig(
            learning_rate=p["lr"], steps=p["steps"],
            feature_dropout=p.get("feature_dropout", 0.3)))
        t0 = time.monotonic()
        params, report = trainer.train(graph)
        risk = trainer.score(params, graph)
        report.update({
            "nodes": graph.n_real, "devices": graph.n_devices,
            "edges": graph.n_edges, "labeled_failures": len(failed),
            "train_seconds": round(time.monotonic() - t0, 3),
            "risk_mean": round(float(risk.mean()), 4) if risk.size else 0.0,
        })

        store = CheckpointStore(engine.checkpoint_root)
        report["checkpoint_version"] = store.save(
            tenant_id, "gnn", params,
            metadata={"report": {k: v for k, v in report.items()
                                 if k != "losses"}})

        at_risk = np.nonzero(risk >= p["risk_threshold"])[0]
        # only *new* predictions are actionable: devices already failed
        # (labeled) don't need a predictive alert
        at_risk = np.asarray([i for i in at_risk if i not in failed],
                             np.int64)
        report["devices_at_risk"] = int(at_risk.shape[0])
        if p["emit_alerts"] and at_risk.shape[0]:
            now = time.time()
            batch = AlertBatch(
                ctx=BatchContext(tenant_id=tenant_id, source="maintenance"),
                device_index=at_risk.astype(np.uint32),
                level=np.full(at_risk.shape[0], 1, np.uint8),  # WARNING
                type=[p["alert_type"]] * at_risk.shape[0],
                message=[f"maintenance risk {risk[i]:.2f} "
                         f"(gnn sweep {op_id[:8]})" for i in at_risk],
                ts=np.full(at_risk.shape[0], now),
                source="model")
            em.add_alert_batch(batch)
        engine._set_status(op_id, BatchOperationStatus.FINISHED_SUCCESSFULLY,
                           ended=True, result=report)


class BatchOperationsService(Service):
    identifier = "batch-operations"
    multitenant = True

    def __init__(self, runtime):
        super().__init__(runtime)
        # training and the maintenance sweep run on the runtime's device:
        # the card unless the instance names another (raises now, before
        # any tenant, when the card is asked for and absent)
        self.device = resolve_device(runtime.settings.device)

    def create_tenant_engine(self, tenant: TenantConfig) -> BatchOperationsEngine:
        return BatchOperationsEngine(self, tenant)

    def operations(self, tenant_id: str) -> BatchOperationsEngine:
        return self.engine(tenant_id)  # type: ignore[return-value]
