"""Desktop GUI application shell (PyTorch port of recon3d_tpu/gui/app.py).

Capability parity with reference src/gui/main_app.py (MainWindow :16-412):
the eight method presets (:79-86), options -> CLI flag mapping (:202-246),
subprocess execution with live log + status, result-file discovery
(:285-293), and a viewer tab. Qt is optional (the reference hard-requires
PyQt5; here the same presets/mapping/discovery are importable headless and
only MainWindow needs Qt).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from recon3d_tpu_torch.runtime.worker import ReconstructionWorker, build_command

# (label, options) presets — reference main_app.py:79-86
METHOD_PRESETS: List[Tuple[str, Dict]] = [
    ("COLMAP Dense (best quality)", {"method": "colmap_dense"}),
    ("COLMAP Sparse (fast)", {"method": "colmap_sparse"}),
    ("Custom: Neural + PatchMatch MVS", {"neural": True, "mvs": True}),
    ("Custom: Neural + Plane-sweep", {"neural": True, "stereo": True}),
    ("Custom: Neural sparse", {"neural": True}),
    ("Custom: SIFT + PatchMatch MVS", {"mvs": True}),
    ("Custom: SIFT + Plane-sweep", {"stereo": True}),
    ("Custom: SIFT sparse", {}),
    ("Custom: Global SfM (rotation averaging)", {"global_sfm": True}),
    ("Custom: SIFT combined (MVS + stereo + SIFT dense)", {"combined": True}),
]


def collect_options(
    preset: Dict,
    quality: str = "medium",
    use_gpu: bool = True,
    max_images: Optional[int] = None,
    output: Optional[str] = None,
    mesh: bool = False,
    serve_socket: Optional[str] = None,
) -> Dict:
    """Merge the widget panel state into a preset's options dict — the
    headless core of the reference's start_reconstruction widget->flags
    mapping (main_app.py:202-246): COLMAP methods take quality/use_gpu,
    custom methods take max_images (>5 to take effect, like the reference's
    spinbox floor) and the output dir."""
    options = dict(preset)
    if options.get("method", "").startswith("colmap"):
        options["quality"] = quality
        options["use_gpu"] = use_gpu
    else:
        if max_images is not None and max_images > 5:
            options["max_images"] = max_images
        if mesh:
            options["mesh"] = True
    if output:
        options["output"] = output
    if serve_socket and not options.get("method", "").startswith("colmap"):
        # Route custom-pipeline runs through the persistent reconstruction
        # service (runtime/serve.py): the daemon keeps the device, K1 and the
        # pipeline's modules loaded across requests. The worker auto-starts
        # the daemon on first use.
        options["serve_socket"] = serve_socket
    return options

# output files to look for after a run — reference main_app.py:285-293
RESULT_CANDIDATES = [
    "dense_mvs.ply",
    "dense_stereo.ply",
    "dense.ply",
    "mesh.ply",  # TSDF mesh: viewer shows its vertices as a cloud
    "sparse.ply",
]


def find_result_file(output_dir: str) -> Optional[str]:
    """First existing result PLY in preference order (reference :285-293)."""
    for name in RESULT_CANDIDATES:
        p = os.path.join(output_dir, name)
        if os.path.exists(p):
            return p
    return None


try:
    from PyQt5 import QtWidgets, QtCore  # type: ignore

    HAS_QT = True
except Exception:  # pragma: no cover
    HAS_QT = False

if HAS_QT:  # pragma: no cover - needs a display

    class MainWindow(QtWidgets.QMainWindow):
        """Reconstruction launcher + viewer (reference MainWindow)."""

        log_line = QtCore.pyqtSignal(str)
        status_line = QtCore.pyqtSignal(str)
        run_done = QtCore.pyqtSignal(bool)

        def __init__(self):
            super().__init__()
            from recon3d_tpu_torch.gui.viewer import ViewerTab

            self.setWindowTitle("recon3d_tpu_torch")
            tabs = QtWidgets.QTabWidget()
            self.setCentralWidget(tabs)

            run_tab = QtWidgets.QWidget()
            form = QtWidgets.QVBoxLayout(run_tab)
            self.dir_edit = QtWidgets.QLineEdit()
            browse = QtWidgets.QPushButton("Browse...")
            browse.clicked.connect(self._browse)
            row = QtWidgets.QHBoxLayout()
            row.addWidget(self.dir_edit)
            row.addWidget(browse)
            form.addLayout(row)
            self.method_box = QtWidgets.QComboBox()
            for label, _ in METHOD_PRESETS:
                self.method_box.addItem(label)
            self.method_box.currentIndexChanged.connect(self._method_changed)
            form.addWidget(self.method_box)

            # Options panel (reference main_app.py:79-134 widgets):
            # COLMAP rows show quality + GPU; custom rows show max-images.
            opts = QtWidgets.QGroupBox("Options")
            opt_row = QtWidgets.QHBoxLayout(opts)
            self.quality_label = QtWidgets.QLabel("Quality:")
            opt_row.addWidget(self.quality_label)
            self.quality_box = QtWidgets.QComboBox()
            for label in ("low", "medium", "high"):
                self.quality_box.addItem(label)
            self.quality_box.setCurrentIndex(1)
            opt_row.addWidget(self.quality_box)
            self.gpu_check = QtWidgets.QCheckBox("Use GPU (COLMAP)")
            self.gpu_check.setChecked(True)
            opt_row.addWidget(self.gpu_check)
            self.max_label = QtWidgets.QLabel("Max images:")
            opt_row.addWidget(self.max_label)
            self.max_spin = QtWidgets.QSpinBox()
            self.max_spin.setRange(0, 10000)
            self.max_spin.setValue(0)
            self.max_spin.setSpecialValueText("all")
            opt_row.addWidget(self.max_spin)
            self.mesh_check = QtWidgets.QCheckBox("TSDF mesh")
            self.mesh_check.setChecked(False)
            opt_row.addWidget(self.mesh_check)
            opt_row.addWidget(QtWidgets.QLabel("Output:"))
            self.out_edit = QtWidgets.QLineEdit()
            self.out_edit.setPlaceholderText("<dataset>/reconstruction")
            opt_row.addWidget(self.out_edit)
            form.addWidget(opts)

            self.start_btn = QtWidgets.QPushButton("Start reconstruction")
            self.start_btn.clicked.connect(self.start_reconstruction)
            form.addWidget(self.start_btn)
            # determinate 4-step bar driven by sniffed stdout statuses
            # (reference main_app.py progress bar + worker.py:112-122)
            self.progress = QtWidgets.QProgressBar()
            self.progress.setRange(0, 4)
            self.progress.setValue(0)
            form.addWidget(self.progress)
            self.status = QtWidgets.QLabel("idle")
            form.addWidget(self.status)
            self.log = QtWidgets.QPlainTextEdit()
            self.log.setReadOnly(True)
            form.addWidget(self.log)
            tabs.addTab(run_tab, "Reconstruct")

            self.viewer = ViewerTab()
            tabs.addTab(self.viewer, "Viewer")

            self.log_line.connect(self.log.appendPlainText)
            self.status_line.connect(self._status_changed)
            self.run_done.connect(self._finished)
            self.worker: Optional[ReconstructionWorker] = None
            self._method_changed(0)

        def _browse(self):
            d = QtWidgets.QFileDialog.getExistingDirectory(self, "Image dir")
            if d:
                self.dir_edit.setText(d)

        def _method_changed(self, idx: int):
            """Show COLMAP options only for COLMAP presets, max-images only
            for custom ones (reference toggles the same panels)."""
            _, preset = METHOD_PRESETS[idx]
            is_colmap = preset.get("method", "").startswith("colmap")
            for w in (self.quality_label, self.quality_box, self.gpu_check):
                w.setVisible(is_colmap)
            for w in (self.max_label, self.max_spin, self.mesh_check):
                w.setVisible(not is_colmap)

        def _status_changed(self, text: str):
            from recon3d_tpu_torch.runtime.worker import status_step

            self.status.setText(text)
            step = status_step(text)
            if step is not None:
                self.progress.setValue(step)

        def start_reconstruction(self):
            dataset = self.dir_edit.text().strip()
            if not dataset:
                return
            _, preset = METHOD_PRESETS[self.method_box.currentIndex()]
            out = self.out_edit.text().strip() or str(
                Path(dataset) / "reconstruction"
            )
            options = collect_options(
                preset,
                quality=self.quality_box.currentText(),
                use_gpu=self.gpu_check.isChecked(),
                max_images=self.max_spin.value() or None,
                output=out,
                mesh=self.mesh_check.isChecked(),
            )
            self._out_dir = out
            self.worker = ReconstructionWorker(
                on_log=self.log_line.emit,
                on_status=self.status_line.emit,
                on_finished=self.run_done.emit,
            )
            self.start_btn.setEnabled(False)
            self.progress.setValue(0)
            self.worker.start_async(dataset, options)

        def _finished(self, ok: bool):
            self.start_btn.setEnabled(True)
            self.status.setText("done" if ok else "FAILED")
            if ok:
                self.progress.setValue(4)
            result = find_result_file(self._out_dir)
            if ok and result:
                self.viewer.load_ply_file(result)


def main():  # pragma: no cover
    if not HAS_QT:
        raise SystemExit(
            "PyQt5 is not installed. Use the CLI (python -m recon3d_tpu_torch.cli) "
            "or the headless viewer (recon3d_tpu_torch.gui.viewer.render_turntable)."
        )
    import sys

    app = QtWidgets.QApplication(sys.argv)
    win = MainWindow()
    win.show()
    sys.exit(app.exec_())


if __name__ == "__main__":  # pragma: no cover
    main()
